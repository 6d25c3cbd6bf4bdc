"""Drop-in ``DefaultInference`` name for users migrating from the reference.

Port of ``pydeseq2_tpu/default_inference.py``. The reference's
``DefaultInference(n_cpus, backend, batch_size, joblib_verbosity)`` is a
joblib process pool (pydeseq2/default_inference.py:14-48); here the default
backend is :class:`~pydeseq2_tpu_torch.torch_inference.TorchInference`, so
this class accepts (and ignores) the pool knobs and forwards the rest.
"""

from __future__ import annotations

import warnings

from pydeseq2_tpu_torch.torch_inference import TorchInference


class DefaultInference(TorchInference):
    """Default inference backend (gene-batched PyTorch kernels, float64 on
    ``"cuda"`` unless ``dtype`` / ``device`` say otherwise).

    ``n_cpus``, ``backend``, ``batch_size`` and ``joblib_verbosity`` have no
    effect: per-gene work runs as batched device programs, not in a pool.
    """

    def __init__(
        self,
        n_cpus: int | None = None,
        backend: str = "loky",
        batch_size: int = 128,
        joblib_verbosity: int = 0,
        **torch_kwargs,
    ) -> None:
        if backend not in ("loky", "multiprocessing", "threading"):
            warnings.warn(
                f"Unknown joblib backend {backend!r} ignored: the PyTorch backend "
                "executes per-gene work as batched device programs.",
                UserWarning,
                stacklevel=2,
            )
        super().__init__(**torch_kwargs)
