"""fastk_tpu_torch — the PyTorch and CUDA port of fastk_tpu.

The port runs beside the JAX package, which stays the reference: on the same
input it writes the same bytes. It imports nothing of ``fastk_tpu``, so it
runs where that package is absent. It keeps its own copies of the host code
it needs, under the JAX package's layout: the readers (``io/``), the file
formats (``formats/``), the native C scanner, packer and profile codecs
(``native/``, built into ``_build/`` at first use), the numpy canonical form
(``ops/canonical.py``), the table algebra (``algebra.py``) and the host
tools (``tools/``). The device code is rewritten here in torch ops, and the
package's Pallas kernel is a CUDA kernel written for Hopper (``csrc/``).

Covered so far: the counting job with its ``.hist``, ``.ktab`` (``-t``) and
``.prof`` (``-p``, ``-p:<table>``) outputs, in core, single and multi batch
(:func:`fastk_tpu_torch.pipeline.count.count_files`), and out of core under
``-M`` with resume (:func:`fastk_tpu_torch.pipeline.outofcore
.count_files_ooc`); the CLIs ``fastk`` and ``kmermap``; the table tools
(``fastmerge``, ``fastcat``, ``logex``, ``vennex``, ``histex``, ``tabex``,
``profex``, ``haplex``, ``homex``, ``symmex``, ``fastrm``, ``fastcp``,
``fastmv``), each run as ``python -m fastk_tpu_torch.tools.<name>`` or
through its launcher in ``bin/``; the library unions
(``tools.fastmerge.merge_tables``, ``algebra.logex_apply``) on the device;
multi-device counting over torch.distributed, one process a card
(``parallel/``: :func:`fastk_tpu_torch.parallel.host.count_files_sharded`,
:func:`fastk_tpu_torch.parallel.meshooc.count_files_mesh`, the CLI's
multi-process mode).

The public names below are those of ``fastk_tpu``. The format codecs load
eagerly and need only numpy, so the host tools never import torch;
``count_files``, ``count_files_sharded``, ``count_files_mesh`` and
``resolve_device`` load torch at first use. The
device is explicit everywhere (default ``"cuda"``); asking for CUDA where
there is none raises instead of running on the CPU.
"""

from fastk_tpu_torch._version import __version__

from fastk_tpu_torch.formats.hist import Histogram, read_histogram, write_histogram
from fastk_tpu_torch.formats.ktab import (
    KmerTable,
    KmerStream,
    read_ktab,
    write_ktab,
)
from fastk_tpu_torch.formats.prof import (
    ProfileIndex,
    encode_profile,
    decode_profile,
    read_profiles,
    write_prof,
)

def __getattr__(name):
    # lazy: the pipeline and the device pull in torch; the codecs above do not
    if name == "count_files":
        from fastk_tpu_torch.pipeline.count import count_files

        return count_files
    if name == "resolve_device":
        from fastk_tpu_torch.device import resolve_device

        return resolve_device
    if name == "count_files_sharded":
        from fastk_tpu_torch.parallel.host import count_files_sharded

        return count_files_sharded
    if name == "count_files_mesh":
        from fastk_tpu_torch.parallel.meshooc import count_files_mesh

        return count_files_mesh
    raise AttributeError(name)


__all__ = [
    "__version__",
    "count_files",
    "count_files_sharded",
    "count_files_mesh",
    "resolve_device",
    "Histogram",
    "read_histogram",
    "write_histogram",
    "KmerTable",
    "KmerStream",
    "read_ktab",
    "write_ktab",
    "ProfileIndex",
    "encode_profile",
    "decode_profile",
    "read_profiles",
    "write_prof",
]
