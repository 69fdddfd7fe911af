"""Serving and train-step A/B on the card: phase 4 of ``chip_smoke.py``
(the main path at full width, timed and traced) and the merged train step
at ``default_config()`` (batch 8, bf16, Adam; 3 warm-up steps, then the
median wall ms of 10, each ended by ``torch.cuda.synchronize()``) in two
checkouts, alternately, one process per run.

    python3 -m affganwriting_torch.tools.serving_ab PARENT_DIR CHANGE_DIR

runs parent, change, change, parent and prints, for each run, the request
ms, the traced kernel ms, the idle share, the launches per request, each
stage's device ms and the step ms, then one JSON line with all four runs.  Each
directory is a checkout of the repo with its own ``chip_smoke.py``; the
parent is usually ``git archive`` of the parent commit unpacked into a
directory that ``.gitignore`` lists.  Compare two versions only within one
such call: the card's clocks and the host differ between calls.
"""

from __future__ import annotations

import json
import subprocess
import sys

RUN = """
import json, torch, chip_smoke
from affganwriting_torch.ops import cuda_build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cuda_build.build()
cuda_build.library()
from affganwriting_torch.tools.timing import nvidia_smi_line
r = chip_smoke.phase_main_path(torch, {}, nvidia_smi_line())
import statistics, time
from affganwriting_torch.core.config import default_config
from affganwriting_torch.train.state import init_state
from affganwriting_torch.train.step import make_phased_train_step
cfg = default_config()
state = init_state(cfg, seed=chip_smoke.SEED)
gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
batch = chip_smoke.random_batch(torch, cfg, cfg.batch_size, gen, "cuda")
step = make_phased_train_step(cfg, merge_dg=True)
walls = []
for _ in range(13):
    torch.cuda.synchronize()
    t = time.perf_counter()
    step(state, batch, gen)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
r["step_ms"] = statistics.median(walls[3:]) * 1e3
print("AB " + json.dumps(r), flush=True)
"""


def run_phase4(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                         capture_output=True, text=True, check=True)
    line = next(x for x in out.stdout.splitlines() if x.startswith("AB "))
    return json.loads(line[3:])


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv
    runs = []
    for name, tree in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        r = run_phase4(tree)
        runs.append({"tree": name, **r})
        stages = ", ".join(f"{k} {v:.3f}" for k, v in r["stages_ms"].items())
        print(f"{name}: request {r['request_ms']:.3f} ms, kernel "
              f"{r['kernel_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['launches_per_request']:.0f} launches; {stages}; "
              f"train step {r['step_ms']:.3f} ms", flush=True)
    print(json.dumps({"serving_ab": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
