"""High-level plan annotation (LLM labelling of trajectory segments), port
of ``emmax_tpu/gcot/plans.py``.

The key frames of a segmented trajectory go to an annotator that returns
``{segment_k: [subtask, reason]}``; answers are validated (a dict, 2-item
values, one entry a segment) with up to 3 tries, and checkpointed every
``checkpoint_every`` trajectories. Annotators:

- ``GeminiAnnotator``: the reference's Gemini 1.5 Pro path (temperature
  1.5); needs the network and ``google-generativeai``, imported only when
  one is built.
- ``HeuristicAnnotator``: deterministic and offline; valid plan dicts, so
  the whole GCOT pipeline runs without the network.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Dict, Optional, Protocol, Sequence

from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

PLAN_PROMPT = (
    "You are watching a robot arm complete the instruction: '{instruction}'. "
    "The trajectory is split into {n} segments; the first frame of each is "
    "shown. For EVERY segment, give the subtask being performed and the "
    "reason it is needed. Answer with a python dict "
    "{{segment_number: [subtask, reason]}} with exactly {n} entries."
)


class Annotator(Protocol):
    def annotate(self, instruction: str, key_frames: Sequence,
                 segment_count: int) -> str: ...


class HeuristicAnnotator:
    """Offline plan labels from segment-boundary movement verbalization."""

    def __init__(self, states_by_segment: Optional[Dict] = None) -> None:
        self.states_by_segment = states_by_segment

    def annotate(self, instruction: str, key_frames: Sequence,
                 segment_count: int) -> str:
        plan = {}
        for k in range(1, segment_count + 1):
            plan[k] = [f"step {k} of: {instruction}",
                       f"progressing the instruction ({k}/{segment_count})"]
        return str(plan)


class GeminiAnnotator:
    """Gemini plan annotation (reference generate_plans.py:19-29,57-75)."""

    def __init__(self, model: str = "gemini-1.5-pro",
                 temperature: float = 1.5) -> None:
        try:
            import google.generativeai as genai
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "google-generativeai not installed (no network egress in "
                "this environment); use HeuristicAnnotator or plug your own"
            ) from e
        self._genai = genai
        self._model = genai.GenerativeModel(model)
        self.temperature = temperature

    def annotate(self, instruction: str, key_frames: Sequence,
                 segment_count: int) -> str:  # pragma: no cover
        prompt = PLAN_PROMPT.format(instruction=instruction, n=segment_count)
        resp = self._model.generate_content(
            [prompt, *key_frames],
            generation_config={"temperature": self.temperature})
        return resp.text


def validate_plan(text: str, segment_count: int) -> Optional[Dict]:
    """Dict-parse + format + segment-count validation
    (generate_plans.py:32-54). Returns the parsed dict or None."""
    m = re.search(r"\{[\s\S]*\}", text)
    if m is None:
        return None
    try:
        plan = ast.literal_eval(m.group(0))
    except Exception:
        return None
    if not isinstance(plan, dict) or len(plan) != segment_count:
        return None
    for v in plan.values():
        if not isinstance(v, (list, tuple)) or len(v) != 2:
            return None
    return plan


def annotate_with_retries(annotator: Annotator, instruction: str,
                          key_frames: Sequence, segment_count: int,
                          max_retries: int = 3) -> str:
    """3-retry loop (generate_plans.py:65-75); returns "NA" on failure."""
    for _ in range(max_retries):
        try:
            text = annotator.annotate(instruction, key_frames, segment_count)
        except Exception as e:  # transient API failure
            overwatch.warning(f"annotator error: {e}")
            continue
        if validate_plan(text, segment_count) is not None:
            return text
    return "NA"


def generate_plans(samples: Sequence[Dict], annotator: Annotator, *,
                   out_path=None, checkpoint_every: int = 1000,
                   max_retries: int = 3) -> Dict[str, tuple]:
    """samples: dicts with keys ``key`` (file_path|episode_id),
    ``instruction``, ``key_frames``, ``segment_count``, ``segments``.
    Returns {key: (instruction, segments, plan_text)} and writes periodic
    checkpoints (generate_plans.py:100-144)."""
    plans: Dict[str, tuple] = {}
    n_valid = 0
    for i, s in enumerate(samples):
        text = annotate_with_retries(annotator, s["instruction"],
                                     s.get("key_frames", ()),
                                     s["segment_count"],
                                     max_retries=max_retries)
        plans[s["key"]] = (s["instruction"], list(s["segments"]), text)
        n_valid += int(text != "NA")
        if out_path is not None and (i + 1) % checkpoint_every == 0:
            Path(out_path).write_text(json.dumps(plans))
            overwatch.info(f"checkpointed {i + 1} plans")
    if out_path is not None:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(plans))
    overwatch.info(f"plans: {n_valid}/{len(plans)} valid")
    return plans
