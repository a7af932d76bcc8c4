"""Host-side VLA helpers: tokenizer, prompts, action tokenizer, Solver."""

from emmax_torch.vla.action_tokenizer import (ActionTokenizer,
                                              unnormalize_actions,
                                              unnormalize_proprio)
from emmax_torch.vla.prompting import (PromptBuilder,
                                       build_emma_x_task_prompt,
                                       get_prompt_builder)
from emmax_torch.vla.solver import Solver
from emmax_torch.vla.tokenizer import (ByteLevelTokenizer, Tokenizer,
                                       load_tokenizer, pad_to_multiple)

__all__ = [
    "ActionTokenizer", "Solver", "PromptBuilder", "Tokenizer",
    "ByteLevelTokenizer", "load_tokenizer", "pad_to_multiple",
    "get_prompt_builder", "build_emma_x_task_prompt",
    "unnormalize_actions", "unnormalize_proprio",
]
