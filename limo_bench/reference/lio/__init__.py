"""A frozen copy of the port's per-scan step on its plain path.

The modules of ``fast_limo_tpu_torch`` that the scan step reaches
(``models/pipeline``, ``iekf``, ``measurement``, ``mapper``, ``deskew``,
``preprocess``, ``process``, ``state``, the ``ops`` they call and
``utils/config``), copied with their imports pointed here and their kernel
paths taken out: every wrapper runs its plain PyTorch version, on whatever
device its tensors lie.  Later changes to the port do not reach this copy,
and it imports nothing of the port.
"""
