"""The PRV corpus on the port (the counterpart of ``experiments/``'s
families, label protocol, dataset assembly and tiny@180 PRVNet recipe), and
the two checks that hold the port's results against the JAX package's
committed ones on the card: ``check_labels`` and ``check_prvnet``."""
