"""prof_out.host_s_per_gbp: host seconds of encoding and writing profiles
for a gigabase of input: pipeline/count.py's _ProfSink.add_batch (the
native encoder and the .prof writer) and _ProfSink.close."""

SPANS = {
    "prof_out.add": "fastk_tpu_torch.pipeline.count:_ProfSink.add_batch",
    "prof_out.close": "fastk_tpu_torch.pipeline.count:_ProfSink.close",
}


def read(ctx):
    spans = [ctx.spans[n] for n in SPANS if n in ctx.spans]
    if not spans or not any(s.calls for s in spans) or ctx.bases <= 0:
        return None
    return sum(s.host_s for s in spans) / (ctx.bases / 1e9)
