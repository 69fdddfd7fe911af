"""RIMES line dataset: XML parsing + page-grouped index.

The port's copy of ``affganwriting_tpu/data/parse_rimes.py`` (plain
Python, the same records): the reference's ``utils/parseRIMESlines.py``
(getLineBoundaries:12-45) and the index layer of
``datasets/author_rimeslines_dataset.py`` (:117-233).  RIMES has no writer
ids: the reference treats each *page image* as an "author", so the index
exposes the ``by_author`` surface of ``data/parse_iam.AuthorLinesIndex``
and plugs into ``data/parse_iam.AuthorLineDataset``.

Line bboxes come straight from the XML's Top/Bottom/Left/Right attributes
(+1 on the max edges), then get the same per-page mean-height
normalization as IAM: short lines centered out to the mean height, all
lines padded horizontally by mean-height/4.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

from affganwriting_torch.data.parse_iam import LineRecord

TRAIN_XML = "lines_training_2011.xml"
EVAL_XML = "lines_eval_2011_annotated.xml"


def parse_rimes_xml(xml_path: str) -> dict[str, list[LineRecord]]:
    """{page image name: [LineRecord]} (parseRIMESlines.py:12-45)."""
    tree = ET.parse(xml_path)
    root = tree.getroot()
    pages: dict[str, list[LineRecord]] = {}
    for page in root.findall("SinglePage"):
        image = page.attrib["FileName"]
        if "/" in image:
            image = image[image.index("/") + 1:]
        raw = []
        total_h = 0
        for line in page.findall("Paragraph/Line"):
            text = line.attrib["Value"]
            top = int(line.attrib["Top"])
            bot = int(line.attrib["Bottom"])
            left = int(line.attrib["Left"])
            right = int(line.attrib["Right"])
            raw.append(([top, bot + 1, left, right + 1], text))
            total_h += 1 + bot - top
        if not raw:
            continue
        mean_h = total_h / len(raw)
        recs = []
        for i, (b, text) in enumerate(raw):
            b = list(b)
            diff = mean_h - (b[1] - b[0])
            if diff > 0:
                b[0] -= diff / 2
                b[1] += diff / 2
            b[2] -= mean_h / 4
            b[3] += mean_h / 4
            b = tuple(int(round(v)) for v in b)
            recs.append(LineRecord(b, text, f"{image}-{i:02d}", image, image))
        pages[image] = recs
    return pages


class RimesLinesIndex:
    """Same surface as AuthorLinesIndex; 'authors' are page images.

    ``split``: 'train' reads lines_training_2011.xml; 'valid'/'test' read
    lines_eval_2011_annotated.xml (the reference validates on the test
    set with a warning, author_rimeslines_dataset.py:120-125).
    """

    def __init__(self, dir_path: str, split: str = "train",
                 xml_path: Optional[str] = None):
        if xml_path is None:
            name = TRAIN_XML if split == "train" else EVAL_XML
            xml_path = os.path.join(dir_path, name)
        self.by_author = parse_rimes_xml(xml_path)

    @property
    def authors(self) -> list[str]:
        return sorted(self.by_author)

    def __len__(self) -> int:
        return sum(len(v) for v in self.by_author.values())
