"""Prompt-structure subsystem for the LLM4Rec feature-enhance flow: a copy
of the JAX package's ``llm4rec/prompts.py`` (stdlib and numpy only).

Capability parity with `llm4rec/feature_enhance/prompt_setting.md:1-5`, whose
spec is: (1) per-subtask role and task definitions with per-subtask output
correction, (2) a defined input-information format, (3) a defined
output-information format. The subtasks themselves are the knowledge-injection
stages of `llm4rec/intent_generate/readme.md:10-16,27-39`:

  - item attributes: item title/intro/summary → 4-axis item attributes
    (category / topic / content / content-form),
  - next item: full behavior item descriptions → next item title,
  - global intent: full behavior item descriptions → 4-axis preference
    intents,
  - semantic-id variants: item text → cluster id; cluster-id sequence →
    next cluster id.

Everything here is host-side plumbing: a `PromptSpec` renders a structured
prompt for a served LLM and parses + corrects its structured output; the
corrected outputs flow into `IntentCache` (batch precompute / online miss
path) and from there into the ranking model as semantic NS-token features.
The LLM is a pluggable text→text callable, as in `intent_cache`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np

INTENT_AXES = ("category", "topic", "content", "content_form")


@dataclasses.dataclass(frozen=True)
class PromptSpec:
    """Role + task definition and I/O formats for one subtask."""

    name: str
    role: str
    task: str
    input_fields: Sequence[str]          # required payload keys, in order
    output_fields: Sequence[str]         # expected "key: value" output lines
    # per-field allowed-value vocab; correction snaps bad values onto it
    output_vocab: Mapping[str, Sequence[str]] = dataclasses.field(
        default_factory=dict
    )
    # per-field default used when a line is missing/uncorrectable
    output_defaults: Mapping[str, str] = dataclasses.field(default_factory=dict)

    # -- (2) input format ---------------------------------------------------
    def build(self, payload: Mapping[str, Any]) -> str:
        missing = [f for f in self.input_fields if f not in payload]
        if missing:
            raise KeyError(f"{self.name}: payload missing {missing}")
        lines = [f"Role: {self.role}", f"Task: {self.task}", "", "Input:"]
        for f in self.input_fields:
            v = payload[f]
            if isinstance(v, (list, tuple)):
                v = "; ".join(str(x) for x in v)
            lines.append(f"  {f}: {v}")
        lines += ["", "Output exactly these lines:"]
        for f in self.output_fields:
            vocab = self.output_vocab.get(f)
            hint = f" (one of: {', '.join(vocab)})" if vocab else ""
            lines.append(f"  {f}: <{f}>{hint}")
        return "\n".join(lines)

    # -- (3) output format + per-subtask correction -------------------------
    def parse(self, text: str) -> Dict[str, str]:
        """Parse ``key: value`` lines; unknown keys ignored."""
        out: Dict[str, str] = {}
        for line in text.splitlines():
            m = re.match(r"\s*([A-Za-z_][\w ]*?)\s*[:：]\s*(.+?)\s*$", line)
            if m:
                key = m.group(1).strip().lower().replace(" ", "_")
                if key in self.output_fields and key not in out:
                    out[key] = m.group(2)
        return out

    def correct(self, parsed: Mapping[str, str]) -> Dict[str, str]:
        """Snap values onto the field vocab; fill missing fields with
        defaults. Returns a dict covering every output field."""
        fixed: Dict[str, str] = {}
        for f in self.output_fields:
            v = parsed.get(f)
            vocab = self.output_vocab.get(f)
            if v is not None and vocab and v not in vocab:
                lowered = v.lower()
                # containment match either way, else uncorrectable
                cand = [w for w in vocab
                        if w.lower() in lowered or lowered in w.lower()]
                v = cand[0] if cand else None
            if v is None:
                v = self.output_defaults.get(
                    f, vocab[0] if vocab else "unknown"
                )
            fixed[f] = v
        return fixed

    def __call__(self, llm: Callable[[str], str],
                 payload: Mapping[str, Any]) -> Dict[str, str]:
        return self.correct(self.parse(llm(self.build(payload))))


# ---------------------------------------------------------------------------
# (1) the subtasks (intent_generate/readme.md:10-16, 27-39)
# ---------------------------------------------------------------------------

def intent_specs(
    axis_vocab: Optional[Mapping[str, Sequence[str]]] = None,
    num_semantic_ids: int = 0,
) -> Dict[str, PromptSpec]:
    """The five knowledge-injection subtasks as PromptSpecs.

    ``axis_vocab`` maps each of the four intent axes to its allowed label
    vocabulary (deployment-specific); omitted axes are free-text.
    ``num_semantic_ids`` > 0 adds the semantic-ID variant subtasks with a
    closed integer vocab.
    """
    av = dict(axis_vocab or {})
    axes_vocab = {a: tuple(av[a]) for a in INTENT_AXES if a in av}
    specs = {
        "item_attributes": PromptSpec(
            name="item_attributes",
            role="item content analyst for a recommendation system",
            task="Given one item's text, output the item's attribute on each "
                 "of the four axes: category, topic, content, content form.",
            input_fields=("title", "intro", "summary"),
            output_fields=INTENT_AXES,
            output_vocab=axes_vocab,
        ),
        "next_item": PromptSpec(
            name="next_item",
            role="user behavior modeler for a recommendation system",
            task="Given the descriptions of every item the user interacted "
                 "with, in order, predict the title of the next item.",
            input_fields=("behavior_items",),
            output_fields=("next_title",),
        ),
        "global_intent": PromptSpec(
            name="global_intent",
            role="user preference analyst for a recommendation system",
            task="Considering the user's global behavior, output the user's "
                 "preference intent on each of the four axes: category, "
                 "topic, content, content form.",
            input_fields=("behavior_items",),
            output_fields=INTENT_AXES,
            output_vocab=axes_vocab,
        ),
    }
    if num_semantic_ids > 0:
        ids = tuple(str(i) for i in range(num_semantic_ids))
        specs["item_semantic_id"] = PromptSpec(
            name="item_semantic_id",
            role="item content analyst for a recommendation system",
            task="Given one item's text, output the item's semantic cluster "
                 "id.",
            input_fields=("title", "intro", "summary"),
            output_fields=("semantic_id",),
            output_vocab={"semantic_id": ids},
            output_defaults={"semantic_id": "0"},
        )
        specs["next_semantic_id"] = PromptSpec(
            name="next_semantic_id",
            role="user behavior modeler for a recommendation system",
            task="Given the user's item semantic-id sequence, predict the "
                 "next semantic id.",
            input_fields=("semantic_id_sequence",),
            output_fields=("semantic_id",),
            output_vocab={"semantic_id": ids},
            output_defaults={"semantic_id": "0"},
        )
    return specs


class IntentPromptGenerator:
    """`IntentCache`-compatible generator: payload → 4-axis intent vector.

    Runs the ``global_intent`` subtask through the served LLM, corrects the
    output, then encodes each axis label with ``axis_encoder(axis, label) ->
    [d]`` (e.g. a label-embedding table or the semantic-distill student) and
    concatenates to the cache's intent vector.
    """

    def __init__(
        self,
        llm: Callable[[str], str],
        axis_encoder: Callable[[str, str], np.ndarray],
        axis_vocab: Optional[Mapping[str, Sequence[str]]] = None,
    ):
        self.spec = intent_specs(axis_vocab)["global_intent"]
        self.llm = llm
        self.axis_encoder = axis_encoder

    def __call__(self, payload: Mapping[str, Any]) -> np.ndarray:
        labels = self.spec(self.llm, payload)
        return np.concatenate(
            [np.asarray(self.axis_encoder(a, labels[a]), dtype=np.float32)
             for a in INTENT_AXES]
        )
