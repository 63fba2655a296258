"""PyTorch/CUDA port of the V-ETL system (``repro``) for one NVIDIA H100.

The layout mirrors ``repro``: ``configs/``, ``data/``, ``core/``,
``warehouse/`` and ``kernels/`` hold the counterpart of each reference
module at the same path. The package imports ``torch`` and ``numpy``
only; it never imports JAX or anything of ``repro``.

Every entry point takes ``device=None``, which means ``"cuda"``; without
a card it raises (see ``repro_torch.device.resolve``). Pass
``device="cpu"`` explicitly to run on the CPU, as the tests do.
"""
