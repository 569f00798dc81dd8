"""fastk_tpu_torch — the PyTorch and CUDA port of fastk_tpu.

The port runs beside the JAX package, which stays the reference: on the same
input it writes the same bytes. Host code that never imported JAX (the
readers, the file formats, the native C scanner and packer, the CLI helpers)
is shared from ``fastk_tpu`` unchanged; the device code is rewritten here in
torch ops, and the package's Pallas kernel is a CUDA kernel written for
Hopper (``csrc/``).

Covered so far: the counting job with its ``.hist``, ``.ktab`` (``-t``) and
``.prof`` (``-p``, ``-p:<table>``) outputs, in core, single and multi batch
(:func:`fastk_tpu_torch.pipeline.count.count_files`), and out of core under
``-M`` with resume (:func:`fastk_tpu_torch.pipeline.outofcore
.count_files_ooc`); the CLI ``python -m fastk_tpu_torch.tools.fastk`` with
its memory plan; ``python -m fastk_tpu_torch.tools.kmermap``; the table
merge ``fastk_tpu_torch.ops.tables.merge_counted``.

The device is explicit everywhere (default ``"cuda"``); asking for CUDA where
there is none raises instead of running on the CPU.
"""

from fastk_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
