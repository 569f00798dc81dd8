"""sort_keys_roofline: ops/count.py's sort_keys, the attribute that
_sorted_keys, merge_unique_blocks and _join_counts call, against the card's
bandwidth: the least bytes of a call (every key word and carried value read
once and written once) over 3.35 TB/s, divided by the device seconds of the
kernels it launched."""

from kbench.roofline import nbytes, share_pct


def bytes_of(args, kwargs, out):
    s_words, s_values = out
    return nbytes(*s_words, *s_values) * 2


SPANS = {"sort_keys": ("fastk_tpu_torch.ops.count:sort_keys", bytes_of)}


def read(ctx):
    s = ctx.spans.get("sort_keys")
    return share_pct(s.bytes, s.device_s) if s else None
