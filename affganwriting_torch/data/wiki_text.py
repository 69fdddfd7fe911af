"""Wikipedia-style text sampler for generator-only lessons.

The port's copy of ``affganwriting_tpu/data/wiki_text.py`` (plain Python,
the same snippets), the reference's ``line_generation/wiki_text.py``: a
stream of ~50-char text snippets built from whitespace-split,
accent-stripped, charset-filtered words of successive articles.  The
article source:

- a local HF ``datasets`` cache when one exists (``datasets`` is optional
  and imported only then),
- otherwise a plain-text corpus file (one article per paragraph), by
  default ``lotr.txt`` of the port's line assets (``data/lines._REF_DATA``,
  which ``AFFGAN_LINE_DATA`` overrides).

Word processing is the reference's: NFKD accent removal
(wiki_text.py:122-125), filter to the 85-char generation charset (:35),
pop words until the snippet passes 50 chars (:77-85).
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import Iterable, Optional

from affganwriting_torch.data.lines import _REF_DATA

_GENCHARS = set(
    " !\"#&'()*+,-./0123456789:;?"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz")
_PRUNE_HEADERS = {"See also", "Gallery", "External media", "History",
                  "Notes"}
_END_KEYWORDS = ["References", "Sources", "External links"]


def remove_accents(s: str) -> str:
    nfkd = unicodedata.normalize("NFKD", s)
    return nfkd.encode("ASCII", "ignore").decode("utf-8")


def word_process(word: str) -> str:
    p = remove_accents(word)
    return "".join(c for c in p if c in _GENCHARS)


def _strip_article(text: str) -> list[str]:
    """Cut the references tail, split paragraphs, prune section headers
    (wiki_text.py:46-67)."""
    for kw in ([f"\n{k}\n" for k in _END_KEYWORDS]
               + [f"\n{k} \n" for k in _END_KEYWORDS] + ["\nCategory:"]):
        cut = text.find(kw)
        if cut > -1:
            text = text[:cut]
            break
    text = re.sub(r" +", " ", text)
    text = re.sub(r"\n+", "\n", text)
    paras = text.split("\n")
    return [p for p in paras if p.strip() not in _PRUNE_HEADERS]


class WikiText:
    """snippet = wiki[i]: pops processed words until > 50 chars."""

    def __init__(self, articles: Optional[Iterable[str]] = None,
                 corpus_path: Optional[str] = None,
                 hf_cache: Optional[str] = None, snippet_chars: int = 50):
        self.snippet_chars = snippet_chars
        self.words: list[str] = []
        if articles is not None:
            self._articles = iter(articles)
        elif hf_cache and os.path.exists(
                os.path.join(hf_cache, "dataset_info.json")):
            self._articles = self._hf_stream(hf_cache)
        else:
            if corpus_path is None:
                corpus_path = os.path.join(_REF_DATA, "lotr.txt")
            self._articles = self._file_stream(corpus_path)

    @staticmethod
    def _hf_stream(cache_path: str):
        from datasets import load_from_disk  # optional dependency

        data = load_from_disk(cache_path)
        i = 0
        while True:
            yield data[i % data.num_rows]["text"]
            i += 1

    @staticmethod
    def _file_stream(path: str):
        with open(path, errors="ignore") as f:
            text = f.read()
        paras = [p for p in text.split("\n\n") if p.strip()]
        i = 0
        while True:
            yield paras[i % len(paras)]
            i += 1

    def _add_words(self) -> None:
        while not self.words:
            article = next(self._articles)
            for para in _strip_article(article):
                ws = [word_process(w) for w in re.split(r"[ \n]", para)]
                self.words += [w for w in ws if w]

    def __getitem__(self, i: int) -> str:
        ret: list[str] = []
        count = 0
        while count < self.snippet_chars:
            if not self.words:
                self._add_words()
                if ret:
                    break
            ret.append(self.words.pop(0))
            count += len(ret[-1]) + 1
        return " ".join(ret)
