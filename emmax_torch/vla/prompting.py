"""Multi-turn prompt builders.

Functional, data-driven re-implementation of the reference prompt-builder
family (``prismatic/models/backbones/llm/prompting/``):
a single ``PromptBuilder`` engine parameterized by a ``PromptStyle`` spec
replaces the per-family subclasses. Emma-X uses the ``pure`` style
("In: {msg}\\nOut: " / "{msg}</s>", ``base_prompter.py:28-73``); the chat
styles mirror ``llama2_chat_prompter.py`` and ``vicuna_v15_prompter.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

_PRISMATIC_SYS = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
)
_VICUNA_SYS = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions."
)


@dataclasses.dataclass(frozen=True)
class PromptStyle:
    name: str
    wrap_human: Callable[[str], str]
    # system prompt folded into the first human turn; `None` → no system prompt
    default_system: Optional[str] = None
    # how the system text is merged into turn 0: receives (system, wrapped fn, msg)
    system_merge: Optional[Callable[[str, Callable[[str], str], str], str]] = None
    bos: str = "<s>"
    eos: str = "</s>"
    # phi places a newline before EOS (phi_prompter.py:26) and prepends BOS
    # to the very first human turn (phi_prompter.py:36-38)
    gpt_suffix: str = ""
    prepend_bos: bool = False
    # phi keeps the BOS in get_prompt (its tokenizer does not auto-insert
    # one, phi_prompter.py:64-65); llama-family styles strip it
    strip_bos: bool = True


def _llama2_sys_merge(system: str, wrap: Callable[[str], str], msg: str) -> str:
    return wrap(f"<<SYS>\n{system.strip()}\n<</SYS>>\n\n" + msg)


def _vicuna_sys_merge(system: str, wrap: Callable[[str], str], msg: str) -> str:
    return system.strip() + " " + wrap(msg)


STYLES: Dict[str, PromptStyle] = {
    "pure": PromptStyle("pure", wrap_human=lambda m: f"In: {m}\nOut: "),
    "llama2-chat": PromptStyle(
        "llama2-chat", wrap_human=lambda m: f"[INST] {m} [/INST] ",
        default_system=_PRISMATIC_SYS, system_merge=_llama2_sys_merge),
    "vicuna-v15": PromptStyle(
        "vicuna-v15", wrap_human=lambda m: f"USER: {m} ASSISTANT: ",
        default_system=_VICUNA_SYS, system_merge=_vicuna_sys_merge),
    "phi": PromptStyle("phi", wrap_human=lambda m: f"Input: {m}\nOutput: ",
                       bos="<|endoftext|>", eos="<|endoftext|>",
                       gpt_suffix="\n", prepend_bos=True, strip_bos=False),
    "mistral-instruct": PromptStyle(
        "mistral-instruct", wrap_human=lambda m: f"[INST] {m} [/INST] "),
}


class PromptBuilder:
    """Accumulates alternating human/gpt turns into a single prompt string.

    Contract (matching the reference): even turns are "human", odd are "gpt";
    ``<image>`` sentinels are stripped; ``get_prompt`` removes a leading BOS
    (auto-inserted by the tokenizer) and trailing whitespace.
    """

    def __init__(self, style: str = "pure", system_prompt: Optional[str] = None,
                 model_family: str = "openvla") -> None:
        self.style = STYLES[style] if isinstance(style, str) else style
        self.model_family = model_family
        self.system_prompt = (
            system_prompt if system_prompt is not None else self.style.default_system
        )
        self.prompt = ""
        self.turn_count = 0

    def _wrap_gpt(self, msg: str) -> str:
        return f"{msg if msg != '' else ' '}{self.style.gpt_suffix}{self.style.eos}"

    def add_turn(self, role: str, message: str) -> str:
        assert (role == "human") if (self.turn_count % 2 == 0) else (role == "gpt")
        message = message.replace("<image>", "").strip()
        if self.turn_count % 2 == 0:
            if self.turn_count == 0 and self.system_prompt and self.style.system_merge:
                wrapped = self.style.system_merge(
                    self.system_prompt, self.style.wrap_human, message)
            elif self.turn_count == 0 and self.style.prepend_bos:
                wrapped = f"{self.style.bos}{self.style.wrap_human(message)}"
            else:
                wrapped = self.style.wrap_human(message)
        else:
            wrapped = self._wrap_gpt(message)
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        saved_prompt, saved_count = self.prompt, self.turn_count
        try:
            was_first = self.turn_count == 0
            self.add_turn("human", message)
            pot = self.get_prompt()
            if was_first and self.style.prepend_bos \
                    and not self.style.strip_bos:
                # the reference's get_potential_prompt appends ONLY the
                # wrapped human turn — never the turn-0 BOS that add_turn
                # inserts (phi_prompter.py:55-62)
                pot = pot.removeprefix(self.style.bos)
            return pot
        finally:
            self.prompt, self.turn_count = saved_prompt, saved_count

    def get_prompt(self) -> str:
        if self.style.strip_bos:
            return self.prompt.removeprefix(self.style.bos).rstrip()
        return self.prompt.rstrip()


def get_prompt_builder(llm_family: str) -> PromptBuilder:
    """Map an LLM backbone family to its prompt style
    (reference: ``llama2.py:78-89``, ``phi.py``, ``mistral.py``)."""
    mapping = {
        "llama2-pure": "pure", "llama2": "pure", "llama2-chat": "llama2-chat",
        "vicuna": "vicuna-v15", "phi": "phi", "mistral": "pure",
        "mistral-instruct": "mistral-instruct",
    }
    return PromptBuilder(style=mapping.get(llm_family, "pure"))


def build_emma_x_task_prompt(instruction: str, gripper_position) -> str:
    """The Emma-X task prompt used in closed-loop eval
    (reference: ``experiments/robot/bridge/run_bridgev2_eval.py:167`` plus the
    ``PurePromptBuilder`` human wrap applied in ``openvla_utils.py:173-218``).
    """
    task_input = (
        "What action should the robot take to achieve the instruction\n"
        f"INSTRUCTION: \n{instruction}\n"
        f"CURRENT GRIPPER: [{int(gripper_position[0])}, {int(gripper_position[1])}]\n"
    )
    pb = PromptBuilder("pure")
    pb.add_turn("human", task_input)
    return pb.get_prompt()
