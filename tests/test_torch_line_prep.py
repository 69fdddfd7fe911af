"""The port's copies of the JAX package's line-data modules, held bit for
bit (``np.array_equal``, equal records and strings) on the same inputs:
``data/label_prep``, ``data/normalize_line``, ``data/parse_iam`` (XML
boxes, index splits, ``crop_line``, batches with real pages, with the
synthetic fallback and with augmentation and masks), ``data/parse_rimes``,
``data/wiki_text`` and ``utils/graph``.

The IAM checkout is ``tools/iam_fixture.write_iam_checkout``'s (form XMLs
and PNG pages of seeded synthetic lines).  The fallback of a missing page
seeds its synthetic line from ``hash(author) & 0xFFFF`` in both packages;
Python salts string hashes per process, so that image changes with
``PYTHONHASHSEED`` and the two packages agree on it only within one
process, as here.
"""

import json

import numpy as np
import pytest

import affganwriting_tpu.data.label_prep as jlp
import affganwriting_tpu.data.normalize_line as jnl
import affganwriting_tpu.data.parse_iam as jiam
import affganwriting_tpu.data.parse_rimes as jrimes
import affganwriting_tpu.data.wiki_text as jwiki
import affganwriting_tpu.utils.graph as jgraph
import affganwriting_torch.data.label_prep as tlp
import affganwriting_torch.data.normalize_line as tnl
import affganwriting_torch.data.parse_iam as tiam
import affganwriting_torch.data.parse_rimes as trimes
import affganwriting_torch.data.wiki_text as twiki
import affganwriting_torch.utils.graph as tgraph
from affganwriting_tpu.data.lines import LineCharset as JCharset
from affganwriting_torch.data.lines import LineCharset as TCharset
from affganwriting_torch.data.lines import synthetic_line_image
from affganwriting_torch.tools.iam_fixture import write_iam_checkout


@pytest.fixture(scope="module")
def iam(tmp_path_factory):
    root = tmp_path_factory.mktemp("iam")
    xml_dir, _ = write_iam_checkout(str(root))
    return str(root), xml_dir


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def test_label_prep_matches(tmp_path):
    lines = ["a01 hello", "a02 Hello World", "a03 toolongwordhere", "",
             "a04 café", "a05 ok", "b01 x1"]
    assert tlp.clean_gt_lines(lines) == jlp.clean_gt_lines(lines)
    assert tlp.clean_gt_lines(lines, 20) == jlp.clean_gt_lines(lines, 20)
    gt = tmp_path / "gt.txt"
    gt.write_text("\n".join(f"w{i % 5},img{i}.png,word{i}"
                            for i in range(23)) + "\n")
    assert tlp.split_gt_by_writers(str(gt), 0.6) == \
        jlp.split_gt_by_writers(str(gt), 0.6)
    other = tmp_path / "other.txt"
    other.write_text("w9,x.png,a\nw0,img0.png,word0\n")
    n_t = tlp.merge_gt_files([str(gt), str(other)], str(tmp_path / "t.txt"))
    n_j = jlp.merge_gt_files([str(gt), str(other)], str(tmp_path / "j.txt"))
    assert n_t == n_j == 24
    assert (tmp_path / "t.txt").read_text() == \
        (tmp_path / "j.txt").read_text()
    src = tmp_path / "src" / "a" / "b"
    src.mkdir(parents=True)
    for name in ("x.png", "y.jpg", "z.txt"):
        (src / name).write_bytes(name.encode())
    assert tlp.flatten_image_tree(str(tmp_path / "src"),
                                  str(tmp_path / "flat_t")) == \
        jlp.flatten_image_tree(str(tmp_path / "src"),
                               str(tmp_path / "flat_j")) == 2
    assert sorted(p.name for p in (tmp_path / "flat_t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "flat_j").iterdir())


@pytest.mark.parametrize("fn", ["deskew", "skeletonize"])
def test_normalize_line_matches(fn):
    img, _ = synthetic_line_image("slanted ink lines", 7, 64, 256,
                                  return_text=True)
    gray = ((1.0 - img) * 127.5).astype(np.float32)
    # a slant and some noise, so that deskew has a winner to find
    rows = np.arange(64)[:, None]
    gray = np.take_along_axis(gray, (np.arange(256)[None, :]
                                     + rows // 4) % 256, axis=1)
    gray = np.clip(gray + np.random.default_rng(0).normal(
        0, 8, gray.shape), 0, 255).astype(np.float32)
    got, want = getattr(tnl, fn)(gray), getattr(jnl, fn)(gray)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.any(got != gray)


def test_parse_form_xml_and_index_match(iam):
    root, xml_dir = iam
    import os

    for name in sorted(os.listdir(xml_dir)):
        path = os.path.join(xml_dir, name)
        got, want = tiam.parse_form_xml(path), jiam.parse_form_xml(path)
        assert [tuple(r.__dict__.values()) for r in got] == \
            [tuple(r.__dict__.values()) for r in want]
    for split in ("train", "valid", "test"):
        t = tiam.AuthorLinesIndex(xml_dir, split=split)
        j = jiam.AuthorLinesIndex(xml_dir, split=split)
        assert t.authors == j.authors and len(t) == len(j)
        assert {a: [tuple(r.__dict__.values()) for r in rs]
                for a, rs in t.by_author.items()} == \
            {a: [tuple(r.__dict__.values()) for r in rs]
             for a, rs in j.by_author.items()}
    assert len(tiam.AuthorLinesIndex(xml_dir, split="train")) == 18
    assert len(tiam.AuthorLinesIndex(xml_dir, split="valid")) == 9


def test_load_form_image_and_crop_line_match(iam):
    root, xml_dir = iam
    idx = tiam.AuthorLinesIndex(xml_dir, split="train")
    rec = idx.by_author[idx.authors[1]][2]
    page_t = tiam.load_form_image(root, rec.form)
    page_j = jiam.load_form_image(root, rec.form)
    np.testing.assert_array_equal(page_t, page_j)
    assert tiam.load_form_image(root, "no-such-form") is None
    jrec = jiam.LineRecord(*rec.__dict__.values())
    for h in (64, 32):
        got, want = tiam.crop_line(page_t, rec, h), jiam.crop_line(
            page_j, jrec, h)
        np.testing.assert_array_equal(got, want)
        assert got.shape[0] == h and got.max() > 0.5


@pytest.mark.parametrize("pages,extra", [
    ("real", {}), ("missing", {}),
    ("real", {"augment": True, "with_fg_mask": True})],
    ids=["real_pages", "fallback", "augment_fg_mask"])
def test_author_line_dataset_batches_match(iam, tmp_path, pages, extra):
    root, xml_dir = iam
    image_dir = root if pages == "real" else str(tmp_path)
    kw = dict(a_batch_size=2, seed=3, **extra)
    t = tiam.AuthorLineDataset(tiam.AuthorLinesIndex(xml_dir), image_dir,
                               TCharset(), **kw)
    j = jiam.AuthorLineDataset(jiam.AuthorLinesIndex(xml_dir), image_dir,
                               JCharset(), **kw)
    for epoch in (0, 1):
        _batches_equal(t.batches(2, epoch=epoch), j.batches(2, epoch=epoch))
    batch = next(t.batches(2))
    assert batch["image"].shape[:2] == (4, 64)
    assert batch["label_lengths"].min() > 0


_RIMES = """<?xml version="1.0" encoding="utf-8"?>
<DocumentList>
  <SinglePage FileName="train/page_{a}.png">
    <Paragraph>
      <Line Value="Bonjour madame" Top="{t}" Bottom="{b}" Left="40" Right="500"/>
      <Line Value="court" Top="300" Bottom="330" Left="60" Right="200"/>
    </Paragraph>
  </SinglePage>
  <SinglePage FileName="page_{c}.png">
    <Paragraph>
      <Line Value="une ligne" Top="90" Bottom="170" Left="10" Right="700"/>
    </Paragraph>
  </SinglePage>
  <SinglePage FileName="empty.png"><Paragraph/></SinglePage>
</DocumentList>
"""


def test_parse_rimes_matches(tmp_path):
    for split, name in (("train", trimes.TRAIN_XML),
                        ("valid", trimes.EVAL_XML)):
        (tmp_path / name).write_text(_RIMES.format(
            a=split, t=100, b=180 if split == "train" else 120,
            c=split + "2"))
        t = trimes.RimesLinesIndex(str(tmp_path), split=split)
        j = jrimes.RimesLinesIndex(str(tmp_path), split=split)
        assert t.authors == j.authors and len(t) == len(j) == 3
        assert {a: [tuple(r.__dict__.values()) for r in rs]
                for a, rs in t.by_author.items()} == \
            {a: [tuple(r.__dict__.values()) for r in rs]
             for a, rs in j.by_author.items()}
        assert isinstance(next(iter(t.by_author.values()))[0],
                          tiam.LineRecord)


def test_wiki_text_matches(tmp_path):
    words = ["naïve", "Café!", "über-cool", "aß", "x_y"]
    assert [twiki.remove_accents(w) for w in words] == \
        [jwiki.remove_accents(w) for w in words]
    assert [twiki.word_process(w) for w in words] == \
        [jwiki.word_process(w) for w in words]
    t, j = twiki.WikiText(), jwiki.WikiText()
    assert [t[i] for i in range(40)] == [j[i] for i in range(40)]
    articles = ["Intro  text here\n\nHistory\nMore words in a row "
                "été\nReferences\ncut away", "Second one. " * 9]
    t = twiki.WikiText(articles=iter(articles), snippet_chars=20)
    j = jwiki.WikiText(articles=iter(articles), snippet_chars=20)
    assert [t[i] for i in range(6)] == [j[i] for i in range(6)]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("one two three\n\nfour five six seven eight\n")
    t = twiki.WikiText(corpus_path=str(corpus), snippet_chars=10)
    j = jwiki.WikiText(corpus_path=str(corpus), snippet_chars=10)
    assert [t[i] for i in range(5)] == [j[i] for i in range(5)]


def test_graph_load_series_and_sparkline_match(tmp_path, capsys):
    path = tmp_path / "metrics.jsonl"
    recs = [{"step": i, "time": 1.0, "group": g, "loss": 1.0 / (i + 1),
             "acc": i, "name": "x"} for i in range(7)
            for g in ("train", "eval")]
    path.write_text("\n".join(json.dumps(r) for r in recs)
                    + "\nnot json\n{\"loss\": 3}\n")
    got, want = tgraph.load_series(str(path)), jgraph.load_series(str(path))
    assert got == want and set(got) == {"train/loss", "train/acc",
                                        "eval/loss", "eval/acc"}
    vals = [v for _, v in got["train/loss"]] * 20
    for width in (40, 7):
        assert tgraph.sparkline(vals, width) == jgraph.sparkline(vals, width)
    assert tgraph.sparkline([]) == ""
