"""The w8a8 serving mode's CER tool on the CPU: ``tools/ab_int8_cer`` on a
checkpoint of the small fp32 config (tests/test_torch_support.py, random
weights from seed 0, saved as ``best``), 2 writers x 4 words.  On random
weights the CER says nothing; the test holds the report's keys, that both
pipelines read every word, and the int8 pipeline against the float one
through the tool's own agreement count.  ``cli/bench --headline int8`` and
``tools/ab_int8_static`` need the card (``chip_smoke.py`` phase 10c;
``tests/test_torch_hygiene.py`` holds their refusal here)."""

import json

import torch

from affganwriting_torch.core.checkpoint import CheckpointManager
from affganwriting_torch.tools import ab_int8_cer
from affganwriting_torch.train.state import init_state
from test_torch_support import small_torch_config

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def test_ab_int8_cer_on_a_checkpoint(tmp_path, capsys):
    cfg = small_torch_config()
    CheckpointManager(str(tmp_path)).save(
        "best", init_state(cfg, "cpu", seed=0), cfg)
    out = ab_int8_cer.main(["--ckpt", str(tmp_path), "--writers", "2",
                            "--words", "4", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert set(out) == {"ckpt", "writers", "words", "corpus", "split",
                        "bf16", "int8", "delta_cer", "pred_token_agreement"}
    assert out["writers"] == 2 and out["words"] == 4
    for k in ("bf16", "int8"):
        assert out[k]["count"] == 8 and out[k]["cer"] >= 0
    assert out["delta_cer"] == round(out["int8"]["cer"] - out["bf16"]["cer"],
                                     3)
    assert 0.0 <= out["pred_token_agreement"] <= 1.0
