"""1 - the union of the kernels' intervals over the traced span's wall time."""


def read(rec):
    return 1.0 - rec.busy_s() / rec.window_s if rec.kernels else None
