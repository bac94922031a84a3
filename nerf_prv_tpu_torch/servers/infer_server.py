"""PRVNet inference daemon — ready-file IPC compatible.

Counterpart of ``servers/infer_server.py`` (≙ ``PRVNet/infer_server.py:72-100``):
poll ``<root>/data/ready_c++.txt``, read the pattern-[0, 1, 3] PNGs from
``data/images/``, forward PVBNet on ``device``, write the rounded [13, 58]
budget to ``data/view_budget.txt``, touch ``ready_py.txt``.

    python -m nerf_prv_tpu_torch.servers.infer_server --root . --checkpoint best_checkpoint.msgpack
"""

import argparse
import os
import time

from ..prvnet.infer import BudgetPredictor


def serve(root: str, checkpoint: str, poll_s: float = 0.1, once: bool = False, device="cuda",
          **predictor_kw) -> None:
    """``predictor_kw`` go to :class:`BudgetPredictor` (``arch``, ``crop``...)."""
    predictor = BudgetPredictor(checkpoint, device=device, **predictor_kw)
    data = os.path.join(root, "data")
    os.makedirs(data, exist_ok=True)
    ready_in = os.path.join(data, "ready_c++.txt")
    ready_out = os.path.join(data, "ready_py.txt")
    while True:
        while not os.path.isfile(ready_in):
            time.sleep(poll_s)
        time.sleep(0.1)
        os.remove(ready_in)
        budget = predictor.predict_from_dir(os.path.join(data, "images"))
        print(f"view budget is {budget}")
        with open(os.path.join(data, "view_budget.txt"), "w") as f:
            f.write(f"{budget}\n")
        open(ready_out, "a").close()
        if once:
            return


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=".", help="dir containing data/")
    p.add_argument("--checkpoint", default="./checkpoints/best_checkpoint.msgpack")
    p.add_argument("--device", default="cuda")
    p.add_argument("--once", action="store_true")
    args = p.parse_args()
    serve(args.root, args.checkpoint, once=args.once, device=args.device)
