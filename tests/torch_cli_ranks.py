"""One rank of a port CLI under the launcher, at the tests' small
configuration (no tests here):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torch_cli_ranks.py train_word --mesh 2 --device cpu ...

``train_word`` builds ``default_config()`` with its flags: here that is
the small fp32 configuration of ``tests/test_torch_support.py`` (dims
only; resnet18 by flag), so a step on the CPU takes seconds.  TensorBoard
is kept out.  Torch-only: the launcher's ranks import no jax.
"""

import sys

import torch

import affganwriting_torch.utils.logging as logging
from affganwriting_torch.cli import generate_word, train_line, train_word
from affganwriting_torch.core.config import default_config

# test_torch_support.SMALL with TRAIN_SMALL's D/C depth and writers
SMALL = dict(compute_dtype="float32", img_height=32, img_width=104,
             max_chars=6, style_dim=64, adain_param_dim=512,
             text_embed_dim=16, rec_hidden=64, rec_embed=16, dis_layers=5,
             num_writers=8)


def small_config():
    return default_config().replace(**SMALL)


if __name__ == "__main__":
    torch.set_num_threads(1)
    logging.summary_writer = lambda logdir: None
    train_word.default_config = small_config
    name, argv = sys.argv[1], sys.argv[2:]
    {"train_word": train_word.main, "generate_word": generate_word.main,
     "train_line": train_line.main}[name](argv)
