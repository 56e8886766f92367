"""prefill_tok_s: the program's `gen_stats` over the untraced window's
generate calls: prompt tokens (padded to the 128-token bucket) over
prefill seconds (each ending in a synchronize)."""


def read(ctx):
    calls = ctx.calls()
    secs = sum(c["prefill_s"] for c in calls)
    return sum(c["prompt_tokens"] for c in calls) / secs if calls and secs > 0 else None
