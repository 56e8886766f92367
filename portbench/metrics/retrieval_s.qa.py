"""retrieval_s.qa: per answer of the untraced window, the seconds of the
benchmark's span around `_history_prompt` (the MiniLM dialogue bank) plus
the answer's own `AnswerResult.process_time` (colbert query embedding,
tree search, short memory, prompt assembly); the mean."""


def read(ctx):
    units = ctx.units()
    hist = {s["unit"]: s["t1"] - s["t0"] for s in ctx.spans("history")}
    if not units:
        return None
    return sum(hist.get(u.index, 0.0) + u.retrieval_s for u in units) / len(units)
