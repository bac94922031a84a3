"""NeRF train-server daemon — ready-file IPC compatible.

Counterpart of ``servers/train_server.py`` (≙
``Instantngp_scripts/train_server.py:6-14``): poll for
``<root>/interact/ready_c++.txt``, delete it, execute
``<root>/interact/run_with_c++.py`` (the command script a legacy client
writes), then touch ``ready_py.txt``.  The in-process pipeline calls
``nerf_prv_tpu_torch.nerf.api`` directly instead.

    python -m nerf_prv_tpu_torch.servers.train_server --root .
"""

import argparse
import os
import subprocess
import sys
import time


def serve(root: str, poll_s: float = 0.1, once: bool = False) -> None:
    interact = os.path.join(root, "interact")
    os.makedirs(interact, exist_ok=True)
    ready_in = os.path.join(interact, "ready_c++.txt")
    ready_out = os.path.join(interact, "ready_py.txt")
    script = os.path.join(interact, "run_with_c++.py")
    while True:
        while not os.path.isfile(ready_in):
            time.sleep(poll_s)
        os.remove(ready_in)
        subprocess.run([sys.executable, script], check=False)
        open(ready_out, "a").close()
        if once:
            return


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=".", help="dir containing interact/")
    p.add_argument("--once", action="store_true")
    args = p.parse_args()
    serve(args.root, once=args.once)
