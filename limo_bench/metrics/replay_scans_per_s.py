"""Scans whose poses were completed in the window over its seconds; the
window ends in ``flush()`` and ``torch.cuda.synchronize()``."""


def read(run):
    w = run.window
    return len(w.scans) / (w.t1 - w.t0) if w.scans else None
