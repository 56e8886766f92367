"""How `correct` is decided: what the window's timed path produced, judged
against the plain reference (portbench/reference) once the window has
closed and the program is gone. The traffic kind's driver says what its
window produced (`check_inputs`: the requests judged, each with what the
reference needs, and the kept frames); this module judges them.

Numbers compared, each with a limit from the configuration file:
  vit_rel_err       the largest relative L2 error of the projected patch
                    features of kept frames (two a segment, one from each
                    half of its ViT batch) against the reference's features
                    of the same frames, made from the same pixels; and of
                    each frame of an answer's short memory against the
                    nearest of the frames it was drawn from (1 or more
                    where the frames matched are out of order or repeat);
  memory_logit_gap  the widest gap by which a greedily served token's logit
                    lies below the reference's best, over a seeded sample
                    of the window's greedy captions and every summary the
                    window finished; for a caption the reference takes the
                    frames and the prompt text and makes the visual tokens
                    itself, for a summary it takes the prompt text;
  answer_logit_gap  the same over greedy answers; the reference makes the
                    short memory from the frames matched above and takes
                    the retrieved nodes' centroids from the program's tree;
  query_rel_err     the relative L2 error of the colbert embedding of those
                    answers' questions (the tree search's query);
  search_score_gap  the widest gap between the tree search's scores (the
                    cosine of the question's embedding and each caption
                    embedding of the tree, as `memory/tree.search` ranks
                    them) from the program's embeddings and the
                    reference's, each batch of captions embedded as the
                    program embedded it.
With `control` the same inputs also go through the reference in the
configuration's control precision (`control` in the configuration file),
put in the program's place: for the logit gaps, the token the control puts
first at each position is judged as a served token would be.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import model as ref
from portbench.seeds import subseed


def sample_calls(calls: List[dict], n: int, rng: np.random.Generator) -> List[dict]:
    """The longest of `calls` (prompt and served tokens) and a seeded
    sample of the rest, n in all, in their order."""
    if not calls:
        return []
    longest = max(range(len(calls)),
                  key=lambda i: (calls[i]["seq_len"] + len(calls[i]["tokens"]), -i))
    rest = [i for i in range(len(calls)) if i != longest]
    picks = [longest] + [int(i) for i in rng.permutation(rest)[:max(0, min(n, len(calls)) - 1)]]
    return [calls[i] for i in sorted(picks)]


def kept_frames(kept: Dict[int, tuple], units: List[int]) -> List[tuple]:
    """(frame index, host feature row) of the frames kept in `units`."""
    return [(i, row.float().cpu()) for u in dict.fromkeys(units)
            for i, row in zip(kept[u][0], kept[u][1])]


def gather(driver, window, spec: dict, seed: int) -> dict:
    """Host copies of what the judged requests produced and took, drawn
    from the seed among the window's finished greedy requests."""
    rng = np.random.default_rng(subseed(seed, "check"))
    return driver.check_inputs(window, int(spec["check_requests"]), rng)


def release_program() -> None:
    """Free what the program holds on the card before the reference runs."""
    from streamchat_tpu_torch.models import step_graph

    step_graph.release()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _decoder_inputs(dec: ref.Decoder, prompt: str, blocks: List[torch.Tensor],
                    tokens: List[int], device) -> tuple:
    parts, bi = [], 0
    for piece in ref.prompt_pieces(prompt):
        if piece is None:
            parts.append(blocks[bi].to(device))
            bi += 1
        else:
            parts.append(dec.embed(piece))
    n_prompt = sum(p.shape[0] for p in parts)
    if len(tokens) > 1:
        parts.append(dec.embed(tokens[:-1]))
    return torch.cat(parts), n_prompt


def _cosines(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """`memory/tree.search`'s score: each row's cosine with q."""
    rows, q = rows.float(), q.float().reshape(-1)
    rows = rows / rows.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return rows @ (q / q.norm().clamp_min(1e-12))


def judge(cfg: dict, seed: int, video, inputs: dict, device,
          control: bool = False) -> Dict[str, dict]:
    """-> {number: {"value", "limit"(, "control")}}."""
    limits = cfg.get("limits", {})
    ctl = cfg.get("control", {})
    serving = cfg["serving"]
    mode = (int(serving["weight_bits"]), 8 if serving.get("kv_int8") else None)
    bc = cfg["tree_embedder"]
    got: Dict[str, List[float]] = {}
    ctrl: Dict[str, List[float]] = {}

    def put(name, value, ctrl_value=None):
        got.setdefault(name, []).append(float(value))
        if ctrl_value is not None:
            ctrl.setdefault(name, []).append(float(ctrl_value))

    def features(frames, precision="f32"):
        return ref.image_features(cfg, seed, np.stack([video.frame(i) for i in frames]), device,
                                  precision)

    def embed(texts, precision="f32"):
        return ref.text_embedding(bc, seed, "tree_embedder", texts, device, precision)

    windows: Dict[tuple, tuple] = {}     # short-memory frames -> reference (, control) features
    batches: Dict[int, tuple] = {}       # the program's caption batches -> reference (, control)
    with torch.no_grad(), ref.float32_matmuls():
        if inputs["frames"]:
            idx = [i for i, _ in inputs["frames"]]
            rows = torch.stack([row for _, row in inputs["frames"]]).to(device)
            want = features(idx)
            put("vit_rel_err", ref.rel_err(rows, want).max(),
                ref.rel_err(features(idx, ctl["vision"]), want).max() if control else None)
            del rows, want
        dec = ref.Decoder(cfg, seed, device)
        modes = [mode] + ([tuple(ctl["decoder"])] if control else [])
        for r in inputs["requests"]:
            if "frames" in r:
                feats = features(r["frames"])
                blocks = [feats.reshape(-1, feats.shape[-1])]
                del feats
            else:
                blocks = [b.to(device) for b in r["blocks"]]
            if "short" in r:
                key = tuple(r["short"]["frames"])
                if key not in windows:
                    windows[key] = (features(key),
                                    features(key, ctl["vision"]) if control else None)
                want, want_ctl = windows[key]
                short = r["short"]["got"].to(device)
                errs = torch.stack([ref.rel_err(short, w.expand_as(short)) for w in want], 1)
                err, match = errs.min(1)
                value = float(err.max())
                if not bool((match[1:] > match[:-1]).all()):
                    value = max(value, 1.0)
                put("vit_rel_err", value,
                    ref.rel_err(want_ctl[match], want[match]).max() if control else None)
                blocks = [torch.cat([want[match].reshape(-1, want.shape[-1])] + blocks)]
                del short, errs
            elif len(blocks) > 1:
                blocks = [torch.cat(blocks)]
            if "question" in r:
                q_ref = embed([r["question"]])
                q_ctl = embed([r["question"]], ctl["embedder"]) if control else None
                put("query_rel_err", ref.rel_err(r["query"][None].to(device), q_ref).max(),
                    ref.rel_err(q_ctl, q_ref).max() if control else None)
                if r.get("nodes"):
                    if id(r["nodes"]) not in batches:
                        batches[id(r["nodes"])] = (
                            torch.cat([embed(t) for t, _ in r["nodes"]]),
                            torch.cat([embed(t, ctl["embedder"]) for t, _ in r["nodes"]])
                            if control else None)
                    n_ref, n_ctl = batches[id(r["nodes"])]
                    s_ref = _cosines(n_ref, q_ref[0])
                    s_got = _cosines(torch.cat([e for _, e in r["nodes"]]), r["query"]).to(device)
                    put("search_score_gap", (s_got - s_ref).abs().max(),
                        (_cosines(n_ctl, q_ctl[0]) - s_ref).abs().max() if control else None)
            embeds, n_prompt = _decoder_inputs(dec, r["prompt"], blocks, r["tokens"], device)
            del blocks
            toks = torch.tensor(r["tokens"], device=device)
            logits = dec.logits(embeds, (n_prompt - 1, n_prompt - 1 + len(r["tokens"])), modes)
            put(r["gap"], ref.served_logit_gaps(logits[0], toks).max(),
                ref.served_logit_gaps(logits[0], logits[1].argmax(-1)).max() if control else None)
            del embeds, logits
    out: Dict[str, dict] = {}
    for name, values in got.items():
        out[name] = {"value": max(values), "limit": limits.get(name)}
        if name in ctrl:
            out[name]["control"] = max(ctrl[name])
    return out


def verdict(numbers: Dict[str, dict], expected: List[str]) -> bool:
    """Correct when every expected number was read and lies within its limit."""
    for name in expected:
        rec = numbers.get(name)
        if rec is None or rec["limit"] is None or not np.isfinite(rec["value"]) \
                or rec["value"] > rec["limit"]:
            return False
    return True
