"""LLM summarization of the dialogue MemoryBank.

Rebuilds `memory_bank/summarize_memory.py:90-132` (per-date history /
personality summaries + overall roll-ups written back into the store) and the
prompt builders from `memory_bank/summarize_memory.py:134-172`. Prompt
strings are behavioral constants and kept verbatim (en branch).

The LLM is injected as a plain callable `generate(prompt) -> str`; in the
pipeline this is the decoder with LLaMA-3 weights (the reference's
LLMClientLLaMA3 / OpenAI client collapse to one function).
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional, Tuple

GenerateFn = Callable[[str], str]

BOOT_NAME = "AI"


def summarize_content_prompt(
    content: List[dict], user_name: str, boot_name: str = BOOT_NAME
) -> str:
    prompt = (
        "Please summarize the following dialogue as concisely as possible, "
        "extracting the main themes and key information. If there are multiple "
        "key events, you may summarize them separately. Dialogue content:\n"
    )
    for dialog in content:
        prompt += f"\n{user_name}：{dialog['query'].strip()}"
        prompt += f"\n{boot_name}：{dialog['response'].strip()}"
    return prompt + "\nSummarization："


def summarize_person_prompt(
    content: List[dict], user_name: str, boot_name: str = BOOT_NAME
) -> str:
    prompt = (
        f"Based on the following dialogue, please summarize {user_name}'s "
        "personality traits and emotions, and devise response strategies based "
        "on your speculation. Dialogue content:\n"
    )
    for dialog in content:
        prompt += f"\n{user_name}：{dialog['query'].strip()}"
        prompt += f"\n{boot_name}：{dialog['response'].strip()}"
    return prompt + (
        f"\n{user_name}'s personality traits, emotions, and {boot_name}'s "
        "response strategy are:"
    )


def summarize_overall_prompt(content: List[Tuple[str, dict]]) -> str:
    prompt = (
        "Please provide a highly concise summary of the following event, "
        "capturing the essential key information as succinctly as possible. "
        "Summarize the event:\n"
    )
    for date, summary_dict in content:
        prompt += f"At {date}, the events are {summary_dict['content'].strip()}"
    return prompt + "\nSummarization："


def summarize_overall_personality(content: List[Tuple[str, str]]) -> str:
    prompt = (
        "The following are the user's exhibited personality traits and "
        "emotions throughout multiple dialogues, along with appropriate "
        "response strategies for the current situation:"
    )
    for date, summary in content:
        prompt += f"At {date}, the analysis shows {summary.strip()}"
    return prompt + (
        "Please provide a highly concise and general summary of the user's "
        "personality and the most appropriate response strategy for the AI "
        "lover, summarized as:"
    )


def summarize_memory(
    memory: dict,
    generate: GenerateFn,
    name: Optional[str] = None,
    memory_path: Optional[str] = None,
) -> dict:
    """Fill per-date summary/personality and overall roll-ups in place.

    Dates that already have a non-empty summary/personality are skipped
    (his_flag/person_flag, summarize_memory.py:108-117). When `memory_path`
    is given the updated store is rewritten like the reference (:126-128).
    """
    for user_name, v in memory.items():
        if name is not None and user_name != name:
            continue
        history = v.get("history")
        if history is None:
            continue
        v.setdefault("summary", {})
        v.setdefault("personality", {})
        for date, content in history.items():
            if not v["summary"].get(date):
                his = generate(summarize_content_prompt(content, user_name))
                v["summary"][date] = {"content": his}
            if not v["personality"].get(date):
                person = generate(summarize_person_prompt(content, user_name))
                v["personality"][date] = person
        v["overall_history"] = generate(
            summarize_overall_prompt(list(v["summary"].items()))
        )
        v["overall_personality"] = generate(
            summarize_overall_personality(list(v["personality"].items()))
        )
    if memory_path:
        with open(memory_path, "w", encoding="utf8") as f:
            json.dump(memory, f, ensure_ascii=False)
    return memory
