"""StreamBench annotation curation utilities.

Generalized port of the reference's ad-hoc `tools/` scripts (hard-coded
paths removed, same jobs):
  * stats — question counts / class distribution / video durations
    (tools/static.py:11-120).
  * resample — per-category balanced subsampling of annotations
    (tools/Ego_Class/resample.py).
  * check-videos — verify every referenced video exists and opens
    (tools/check_video_open_ok.py, check_all_data_exsit.py).
  * extract-frames — fps-based frame extraction into per-video folders
    (ego_data.py:6-51; its write loop is commented out upstream and, as
    written, would overwrite one fixed filename — here it works and writes
    indexed frames).

A copy of `streamchat_tpu/tools/streambench.py` (model-free; `plots` draws
through the port's `tools/visualize`).
"""

from __future__ import annotations

import argparse
import json
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional


def annotation_stats(annotations: List[dict], video_dir: Optional[str] = None) -> Dict:
    """Question/class/duration statistics over a StreamBench annotation list."""
    total_questions = 0
    class_counts: Dict[str, int] = defaultdict(int)
    category_counts: Dict[str, int] = defaultdict(int)
    subclass_counts: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    durations = []
    for item in annotations:
        bps = item.get("breakpoint", [])
        total_questions += len(bps)
        c1 = item["info"].get("class_1", "?")
        category_counts[c1] += 1
        subclass_counts[c1][item["info"].get("class_2", "?")] += 1
        for q in bps:
            class_counts[q.get("class", "?")] += 1
        if bps:
            durations.append(max(int(q["time"]) for q in bps))
        if video_dir:
            pass  # existence handled by check_videos
    out = {
        "num_videos": len(annotations),
        "num_questions": total_questions,
        "question_classes": dict(class_counts),
        "categories": dict(category_counts),
        "subclasses": {k: dict(v) for k, v in subclass_counts.items()},
    }
    if durations:
        out["video_seconds"] = {
            "total": sum(durations),
            "mean": sum(durations) / len(durations),
            "max": max(durations),
            "per_video": durations,
        }
    return out


def resample_by_category(
    annotations: List[dict],
    per_category: int,
    seed: int = 0,
    category_key: str = "class_1",
) -> List[dict]:
    """Balanced subsample: up to `per_category` videos per class_1 bucket."""
    rng = random.Random(seed)
    buckets: Dict[str, List[dict]] = defaultdict(list)
    for item in annotations:
        buckets[item["info"].get(category_key, "?")].append(item)
    out: List[dict] = []
    for cat in sorted(buckets):
        items = buckets[cat]
        if len(items) > per_category:
            items = rng.sample(items, per_category)
        out.extend(items)
    return out


def check_videos(annotations: List[dict], video_dir: str, open_check: bool = False) -> List[str]:
    """Missing (or unopenable) video paths."""
    bad: List[str] = []
    for item in annotations:
        path = os.path.join(
            video_dir, item["info"].get("class_1", ""), item["info"]["video_path"]
        )
        if not os.path.exists(path):
            bad.append(path)
            continue
        if open_check:
            import cv2

            cap = cv2.VideoCapture(path)
            if not cap.isOpened():
                bad.append(path)
            cap.release()
    return bad


def extract_frames(
    video_path: str,
    output_folder: str,
    fps: float = 1.0,
    limit: Optional[int] = None,
) -> Dict:
    """Extract frames at `fps` into `output_folder/<video_name>/`.

    Port of the reference's `ego_data.py:6-51` curation utility: same
    interval rule (`int(video_fps / fps)` source frames between writes),
    same per-video subfolder naming, same duration report. Deviations,
    both documented here because the upstream loop is dead code: frames
    are written as `frame_{index:06d}.jpg` (the commented-out reference
    loop reuses one filename, keeping only the last frame) and there is
    no 0.5 s sleep per write.
    """
    import cv2

    video = cv2.VideoCapture(video_path)
    if not video.isOpened():
        raise ValueError(f"cannot open video: {video_path}")
    video_fps = video.get(cv2.CAP_PROP_FPS) or fps
    total_frames = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
    frame_interval = max(int(video_fps / fps), 1)
    video_name = os.path.splitext(os.path.basename(video_path))[0]
    save_path = os.path.join(output_folder, video_name)
    os.makedirs(save_path, exist_ok=True)

    total_duration_sec = total_frames / video_fps if video_fps else 0.0
    hours = int(total_duration_sec // 3600)
    minutes = int((total_duration_sec % 3600) // 60)
    seconds = int(total_duration_sec % 60)

    current_frame = 0
    extracted = 0
    while video.isOpened():
        ret, frame = video.read()
        if not ret:
            break
        if current_frame % frame_interval == 0:
            cv2.imwrite(
                os.path.join(save_path, f"frame_{extracted:06d}.jpg"), frame
            )
            extracted += 1
            if limit is not None and extracted >= limit:
                break
        current_frame += 1
    video.release()
    return {
        "video": video_path,
        "save_path": save_path,
        "video_fps": video_fps,
        "total_frames": total_frames,
        "duration": f"{hours:02}:{minutes:02}:{seconds:02}",
        "extracted_frames": extracted,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="StreamBench curation tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("stats")
    sp.add_argument("--annotations", required=True)

    rp = sub.add_parser("resample")
    rp.add_argument("--annotations", required=True)
    rp.add_argument("--per_category", type=int, required=True)
    rp.add_argument("--output", required=True)
    rp.add_argument("--seed", type=int, default=0)

    cp = sub.add_parser("check-videos")
    cp.add_argument("--annotations", required=True)
    cp.add_argument("--video_dir", required=True)
    cp.add_argument("--open_check", action="store_true")

    pp = sub.add_parser(
        "plots",
        help="distribution PNGs: duration histogram, question-class pie, "
             "domain/subclass sunburst (reference tools/static.py + "
             "draw_sun_pic.py)",
    )
    pp.add_argument("--annotations", required=True)
    pp.add_argument("--out_dir", default=".")

    ep = sub.add_parser(
        "extract-frames",
        help="fps-based frame extraction into output_folder/<video_name>/ "
             "(reference ego_data.py)",
    )
    ep.add_argument("--video", required=True)
    ep.add_argument("--output_folder", required=True)
    ep.add_argument("--fps", type=float, default=1.0)
    ep.add_argument("--limit", type=int, default=None,
                    help="stop after this many extracted frames")

    args = p.parse_args(argv)
    if args.cmd == "extract-frames":
        print(json.dumps(
            extract_frames(args.video, args.output_folder, args.fps,
                           limit=args.limit),
            indent=2))
        return
    with open(args.annotations, encoding="utf-8") as f:
        annotations = json.load(f)

    if args.cmd == "stats":
        print(json.dumps(annotation_stats(annotations), indent=2))
    elif args.cmd == "resample":
        sampled = resample_by_category(annotations, args.per_category, args.seed)
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(sampled, f, ensure_ascii=False, indent=2)
        print(f"wrote {len(sampled)} / {len(annotations)} annotations")
    elif args.cmd == "check-videos":
        bad = check_videos(annotations, args.video_dir, args.open_check)
        print(json.dumps({"missing_or_broken": bad, "count": len(bad)}, indent=2))
    elif args.cmd == "plots":
        from streamchat_tpu_torch.tools.visualize import (
            plot_category_sunburst,
            plot_class_pie,
            plot_duration_histogram,
        )

        stats = annotation_stats(annotations)
        os.makedirs(args.out_dir, exist_ok=True)
        wrote = []
        if stats.get("video_seconds", {}).get("per_video"):
            path = os.path.join(
                args.out_dir, "video_time_distribution_histogram.png")
            plot_duration_histogram(stats["video_seconds"]["per_video"], path)
            wrote.append(path)
        if stats["question_classes"]:
            path = os.path.join(args.out_dir, "class_distribution_pie_chart.png")
            plot_class_pie(stats["question_classes"], path)
            wrote.append(path)
        if stats["subclasses"]:
            path = os.path.join(args.out_dir, "category_sunburst.png")
            plot_category_sunburst(stats["subclasses"], path)
            wrote.append(path)
        print(json.dumps({"wrote": wrote}, indent=2))


if __name__ == "__main__":
    main()
