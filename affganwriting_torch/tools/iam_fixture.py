"""A tiny IAM-format checkout made from seeded synthetic lines.

``write_iam_checkout(root)`` writes ``root/xml/<form>.xml`` (IAM form
XMLs: ``form/@writer-id``, ``handwritten-part/line/@text`` and one word
with one ``cmp`` box per line) and ``root/forms/<form>.png`` (8-bit
grayscale pages, ink dark, written by ``utils/png``) for ``WRITERS``
writers, each with ``FORMS`` forms of the train split and one of the valid
split of ``sets.json``, ``LINES`` lines a form.  Each line is
``data/lines.synthetic_line_image`` of a text from a fixed word list,
seeded from its writer's index (not from ``hash``), and its XML text is
the text the image shows.  ``data/parse_iam`` reads it as it reads IAM;
the tests and ``chip_smoke.py`` use it where the IAM files are not at
hand.
"""

from __future__ import annotations

import os
from xml.sax.saxutils import quoteattr

import numpy as np

from affganwriting_torch.data.lines import load_sets, synthetic_line_image
from affganwriting_torch.utils.png import encode_gray_png

WORDS = ("the quick brown fox jumps over a lazy dog while seven wizards "
         "hum and my black sphinx of quartz judges vows").split()
LINE_H, LINE_W, PAGE_W, TOP, GAP, LEFT = 64, 512, 1200, 120, 40, 80
WRITERS, FORMS, LINES = 3, 2, 3


def write_iam_checkout(root: str) -> tuple[str, str]:
    """Write the checkout under ``root``; returns (xml dir, image dir)."""
    xml_dir, img_dir = os.path.join(root, "xml"), os.path.join(root, "forms")
    os.makedirs(xml_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    sets = load_sets()
    rng = np.random.default_rng(0)
    for w in range(WRITERS):
        names = (sets["train"][w * FORMS:(w + 1) * FORMS]
                 + sets["valid"][w:w + 1])
        for form in names:
            page = np.full((TOP + LINES * (LINE_H + GAP), PAGE_W), 255,
                           np.uint8)
            xml_lines = []
            for k in range(LINES):
                text = " ".join(rng.choice(WORDS, size=6))
                img, drawn = synthetic_line_image(text, 1000 + w, LINE_H,
                                                  LINE_W, return_text=True)
                ink = np.nonzero((img > -1.0).any(axis=0))[0]
                x1 = int(ink[-1]) + 1
                y = TOP + k * (LINE_H + GAP)
                page[y:y + LINE_H, LEFT:LEFT + x1] = np.round(
                    (1.0 - img[:, :x1]) * 127.5).astype(np.uint8)
                lid = f"{form}-{k:02d}"
                xml_lines.append(
                    f'    <line id="{lid}" text={quoteattr(drawn)}>\n'
                    f'      <word id="{lid}-00" text={quoteattr(drawn)}>\n'
                    f'        <cmp x="{LEFT}" y="{y}" width="{x1}" '
                    f'height="{LINE_H}"/>\n'
                    f'      </word>\n    </line>')
            with open(os.path.join(xml_dir, f"{form}.xml"), "w") as f:
                f.write(f'<?xml version="1.0" encoding="ISO-8859-1"?>\n'
                        f'<form id="{form}" writer-id="{w:03d}">\n'
                        f'  <handwritten-part>\n' + "\n".join(xml_lines)
                        + "\n  </handwritten-part>\n</form>\n")
            with open(os.path.join(img_dir, f"{form}.png"), "wb") as f:
                f.write(encode_gray_png(page))
    return xml_dir, img_dir
