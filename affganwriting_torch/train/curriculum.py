"""Lesson curriculum (line_generation/utils/curriculum.py:3-60).

The port's copy of ``affganwriting_tpu/train/curriculum.py``.

``{start_iter: [[lesson tokens], ...]}``; an int token duplicates the lesson
list entry; within the active stage the lesson lists rotate round-robin.
The active config rotates
``count | no-step,gen | auto,auto-gen | disc | no-step,gen | auto,auto-gen |
disc`` (configs/cf_IAMslant_...sMG.json).
"""

from __future__ import annotations


DEFAULT_CURRICULUM = {
    0: [["count"], ["no-step", "gen"], ["auto", "auto-gen"], ["disc"],
        ["no-step", "gen"], ["auto", "auto-gen"], ["disc"]],
}


class Curriculum:
    def __init__(self, spec: dict | None = None):
        spec = spec or DEFAULT_CURRICULUM
        self.stages = []
        for start, lessons in sorted(
                ((int(k), v) for k, v in spec.items())):
            expanded: list[list[str]] = []
            for lesson in lessons:
                dup = 1
                toks = []
                for tok in lesson:
                    if isinstance(tok, int):
                        dup = tok
                    else:
                        toks.append(tok)
                for _ in range(dup):
                    expanded.append(toks)
            self.stages.append((start, expanded))

    def get_lesson(self, iteration: int) -> list[str]:
        active = self.stages[0][1]
        for start, lessons in self.stages:
            if iteration >= start:
                active = lessons
            else:
                break
        return active[iteration % len(active)]

    @property
    def all_lessons(self) -> set[str]:
        out: set[str] = set()
        for _, lessons in self.stages:
            for lesson in lessons:
                out.update(lesson)
        return out

    def get_valid(self) -> list[str]:
        """Validation lesson set (reference curriculum.py:31-33, 55-56):
        every trained token except the GAN ones ('gen'/'disc' — their
        losses aren't informative as validation metrics), plus 'valid'."""
        toks = sorted(t for t in self.all_lessons
                      if "gen" not in t and "disc" not in t
                      and t != "no-step")
        return toks + ["valid"]

    def get_eval(self) -> list[str]:
        """Eval lesson set (curriculum.py:33-34, 57-58): everything except
        the discriminator tokens, plus 'eval'."""
        toks = sorted(t for t in self.all_lessons
                      if "disc" not in t and t != "no-step")
        return toks + ["eval"]
