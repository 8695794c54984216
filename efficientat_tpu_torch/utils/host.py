"""Host-side process tuning for the data/transfer path.

Copy of ``efficientat_tpu/utils/host.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

disable_thp_first_touch(): opt this process out of transparent huge pages
(``prctl(PR_SET_THP_DISABLE)``).

Why: on virtualized hosts with lazily-backed guest RAM (snapshot-restored
or uffd-backed VMs — common for cloud TPU frontends), faulting a 2 MB
transparent huge page pulls the whole 2 MB through the lazy backend in
one synchronous stall. Measured on this machine: the first touch of a
fresh 154 MB numpy buffer costs **7.3 s with THP enabled vs 0.08 s with
it disabled** — a ~90x cliff that lands on every large allocation a data
pipeline makes (collate ``np.stack``, ``astype`` copies, h5py reads),
because glibc munmaps big buffers on free, so every batch faults fresh
mappings. The symptom masquerades as "host->device transfer is 100x too
slow"; the transfer is fine — it is the page-fault path.

THP's TLB benefit is irrelevant for streaming numpy buffers (touched
once, bandwidth-bound), so the trade is strictly good for data-pipeline
processes. The flag is per-process and inherited by forks; it does not
touch system-wide settings.
"""

from __future__ import annotations

import ctypes
import sys

_PR_SET_THP_DISABLE = 41
_done = False


def disable_thp_first_touch() -> bool:
    """Disable transparent huge pages for this process. Idempotent.

    Returns True if the prctl succeeded (or already ran), False on
    non-Linux platforms or if the kernel rejected it.
    """
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        if libc.prctl(_PR_SET_THP_DISABLE, 1, 0, 0, 0) != 0:
            return False
    except Exception:
        return False
    _done = True
    return True
