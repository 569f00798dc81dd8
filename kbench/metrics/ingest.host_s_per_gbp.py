"""ingest.host_s_per_gbp: host seconds of parsing and packing a gigabase of
input: every step of the reader's batch generator (batched_reads, as
pipeline/count.py and the plan in tools/fastk.py call it) and the 2-bit
packer (pack_stream_words, as pipeline/count.py calls it)."""

SPANS = {
    "ingest.read": "fastk_tpu_torch.pipeline.count:batched_reads",
    "ingest.plan_read": "fastk_tpu_torch.tools.fastk:batched_reads",
    "ingest.pack": "fastk_tpu_torch.pipeline.count:pack_stream_words",
}


def read(ctx):
    spans = [ctx.spans[n] for n in SPANS if n in ctx.spans]
    if not spans or not any(s.calls for s in spans) or ctx.bases <= 0:
        return None
    return sum(s.host_s for s in spans) / (ctx.bases / 1e9)
