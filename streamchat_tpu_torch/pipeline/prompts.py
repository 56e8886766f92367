"""Conversation templates and prompt assembly.

Reproduces the ChatML (`qwen_1_5` family) templates the pipeline depends on
(`longva/conversation.py:414-423, 525-592`) and the answer-prompt glue from
`inference_streaming_longva_v2.py:205-228`. The template *strings* are
behavioral constants of the reference (they steer the frozen checkpoint), so
they are kept verbatim; the machinery around them is new.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from streamchat_tpu_torch.models.tokenizer import DEFAULT_IMAGE_TOKEN

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"


@dataclasses.dataclass
class Conversation:
    """ChatML-style conversation (SeparatorStyle.CHATML semantics:
    conversation.py:85-96)."""

    system: str
    roles: Tuple[str, str] = (f"{IM_START}user", f"{IM_START}assistant")
    messages: List[Tuple[str, Optional[str]]] = dataclasses.field(default_factory=list)
    sep: str = IM_END

    def copy(self) -> "Conversation":
        return Conversation(self.system, self.roles, list(self.messages), self.sep)

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        ret = "" if self.system == "" else self.system + self.sep + "\n"
        for role, message in self.messages:
            if message:
                ret += role + "\n" + message + self.sep + "\n"
            else:
                ret += role + "\n"
        return ret


# System prompts verbatim from longva/conversation.py:414-423 (qwen_1_5),
# :525-537 (qwen_1_5_ego), :539-548 (qwen_1_5_caption), :551-560
# (qwen_1_5_summarize). Note the ego/caption/summarize variants carry the
# reference's leading indentation inside the system string.
CONV_TEMPLATES = {
    "qwen_1_5": Conversation(
        system=f"{IM_START}system\nYou are a helpful assistant."
    ),
    "qwen_1_5_ego": Conversation(
        system=(
            f"{IM_START}system\n    You are a useful assistant. What you see is "
            "video from my first-person perspective and you need to conduct "
            "multiple rounds of dialogue with me."
        )
    ),
    "qwen_1_5_caption": Conversation(
        system=(
            f"{IM_START}system\n    You are a useful visual assistant. Please "
            "describe what you see in this video in as much detail as possible "
            "from a first-person perspective, including the surrounding "
            "environment, what objects are there, etc.\n    PLEASE DO NOT "
            "GENERATE TEXT YOU ARE NOT SURE ABOUT."
        )
    ),
    "qwen_1_5_summarize": Conversation(
        system=f"{IM_START}system\n    You are a helpful assistant."
    ),
}


def conv_template(name: str) -> Conversation:
    return CONV_TEMPLATES[name].copy()


def wrap_user_turn(conv_mode: str, user_text: str) -> str:
    """system + one user turn + open assistant turn (the reference's
    conv.append_message x2 + get_prompt pattern)."""
    conv = conv_template(conv_mode)
    conv.append_message(conv.roles[0], user_text)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


# --- Answer-prompt fragments (inference_streaming_longva_v2.py:205-211),
# kept verbatim including the odd spacing: they condition the checkpoint. ---

# The reference writes this with backslash line continuations, so each
# sentence is joined by one space + the 8-space source indentation.
ANSWER_PRM = (
    "In addition, the text caption memory information articles most relevant "
    "to the current problem is '{most_fine_grad_text}'.         "
    "The image information you currently see and recall in the {image_token} "
    "is equally important as the contextual information mentioned earlier.         "
    "Sometimes the contextual information does not contain a direct answer to "
    "the question.         "
    "You need to synthesize this information and give an answer to the "
    "following question:"
)

ANSWER_NOTION = "DO NOT OUTPUT ANY EXPLANATORY TEXT THAT IS UNCERTAIN ABOUT THE CURRENT QUESTION."

CAPTIONING_QUERY = (
    "Please describe what you see in this video in as much detail as possible "
    "from a first-person perspective, including the surrounding environment, "
    "what objects are there, etc."
)

SUMMARIZE_PREFIX = (
    "You need to write a summary of the following, including as many key "
    "details as possible into one sentence."
)

_ORDINALS = [
    "first", "second", "third", "fourth", "fifth",
    "sixth", "seventh", "eighth", "ninth", "tenth",
]

# Dialogue-memory meta prompt (memory_bank/prompt_utils.py:37-43,
# only_related_prompt_dict_ego, language="en").
ONLY_RELATED_PROMPT_EGO = {
    "en": (
        "\n    Based on the current user's question, the most relevant "
        'historical contextual conversation records are: '
        '"{related_memory_content}".\n    '
    )
}


def build_answer_prompt(
    question: str,
    history_prompt: Optional[str],
    most_fine_grad_text: Optional[str],
) -> str:
    """User-turn text for the multimodal answer (reference :213-228,
    mm_use_im_start_end=False branch)."""
    if history_prompt is not None:
        if most_fine_grad_text is not None:
            return (
                history_prompt
                + ANSWER_PRM.format(
                    most_fine_grad_text=most_fine_grad_text,
                    image_token=DEFAULT_IMAGE_TOKEN,
                )
                + "\n" + question + ANSWER_NOTION
            )
        return history_prompt + "\n" + question + ANSWER_NOTION
    return DEFAULT_IMAGE_TOKEN + "\n" + question + ANSWER_NOTION


def build_answer_prompt_unimodal(
    question: str, history_prompt: Optional[str]
) -> str:
    """Uni-modal user turn (reference :93-102): no caption injection, no
    notion suffix."""
    if history_prompt is not None:
        return history_prompt + DEFAULT_IMAGE_TOKEN + "\n" + question
    return DEFAULT_IMAGE_TOKEN + "\n" + question


def build_caption_prompt() -> str:
    """Captioning prompt for memory-tree chunks (updating_memory_buffer,
    inference_streaming_longva_v2.py:284-297; conv qwen_1_5_ego)."""
    return wrap_user_turn("qwen_1_5_ego", DEFAULT_IMAGE_TOKEN + "\n" + CAPTIONING_QUERY)


def build_summary_prompt(captions: List[str]) -> str:
    """Ordinal merge prompt for tree summarization (utiles.py:505-523)."""
    parts = [
        "The caption of the {} video clip is:{} \n".format(_ORDINALS[i], c)
        for i, c in enumerate(captions[: len(_ORDINALS)])
    ]
    qs = SUMMARIZE_PREFIX + " ".join(parts)
    return wrap_user_turn("qwen_1_5_summarize", qs)


def build_history_prompt(related_memory_content: Optional[str], language: str = "en") -> Optional[str]:
    """only_related meta prompt (utiles.py:1057-1078): None when no memory."""
    if related_memory_content is None:
        return None
    return ONLY_RELATED_PROMPT_EGO[language].format(
        related_memory_content=related_memory_content
    )


def build_full_memory_prompt(
    question: str,
    user_name: str,
    user_memory: dict,
    related_memos: List[str],
    memo_dates: str,
    meta_prompt: str,
    new_user_meta_prompt: str,
    history: Optional[List[dict]] = None,
    boot_actual_name: str = "AI",
    user_keyword: str = "[|User|]",
    ai_keyword: str = "[|AI|]",
) -> str:
    """Fuller companion-chat prompt (`build_prompt_with_search_memory`,
    utiles.py:1005-1055, en branch): weaves the overall-history summary, the
    retrieved memories, the personality analysis, and the running dialogue
    into the app-style meta prompt; falls back to the new-user prompt when
    any piece is missing. The v0.3 benchmark path uses the slimmer
    only_related variant above (this one serves the companion/live-app
    prompt dicts in memory_bank/prompt_utils.py)."""
    history_summary = ""
    if "overall_history" in user_memory:
        history_summary = (
            "The summary of your past memories with the user is: "
            f"{user_memory['overall_history']}"
        )
    personality = user_memory.get("overall_personality", "")
    related_memory_content = "\n" + "\n".join(related_memos).strip() + "\n"

    history_text = ""
    for dialog in history or []:
        history_text += f"\n {user_keyword}: {dialog['query']}"
        history_text += f"\n {ai_keyword}: {dialog['response']}"
    history_text += f"\n {user_keyword}: {question} \n {ai_keyword}: "

    if history_summary and related_memos and personality:
        return meta_prompt.format(
            user_name=user_name,
            history_summary=history_summary,
            related_memory_content=related_memory_content,
            personality=personality,
            boot_actual_name=boot_actual_name,
            history_text=history_text,
            memo_dates=memo_dates,
        )
    if related_memos:
        return meta_prompt.format(
            user_name=user_name,
            related_memory_content=related_memory_content,
            boot_actual_name=boot_actual_name,
            memo_dates=memo_dates,
        )
    return new_user_meta_prompt.format(
        user_name=user_name,
        boot_actual_name=boot_actual_name,
        history_text=history_text,
    )
