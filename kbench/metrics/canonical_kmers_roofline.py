"""canonical_kmers_roofline: ops/kmers.py's canonical_kmers, as ops/count.py
calls it, against the card's bandwidth: the least bytes of a call (its codes
read once, its W int64 words and its invalid flags written once) over 3.35
TB/s, divided by the device seconds of the kernels it launched."""

from kbench.roofline import nbytes, share_pct


def bytes_of(args, kwargs, out):
    words, invalid = out
    return nbytes(args[0], *words, invalid)


SPANS = {"canonical_kmers": ("fastk_tpu_torch.ops.count:canonical_kmers",
                             bytes_of)}


def read(ctx):
    s = ctx.spans.get("canonical_kmers")
    return share_pct(s.bytes, s.device_s) if s else None
