"""answer_s: the untraced window's seconds over its answers (host clock): a
question in, its answer out, history retrieval and the store included."""


def read(ctx):
    answers = [u for u in ctx.units() if u.kind == "answer"]
    return ctx.window.seconds / len(answers) if answers else None
