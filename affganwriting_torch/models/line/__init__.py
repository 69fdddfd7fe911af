"""The line-generation models (forward): the port of
``affganwriting_tpu/models/line/`` but for ``DiscriminatorAP`` and
``Autoencoder``, which come with the line trainer."""

from affganwriting_torch.models.line.char_style import CharStyleEncoder
from affganwriting_torch.models.line.container import HWWithStyle
from affganwriting_torch.models.line.count_cnn import CountCNN
from affganwriting_torch.models.line.hwr import CNNOnlyHWR, CRNN, SmallCRNN
from affganwriting_torch.models.line.spaced_gen import SpacedGenerator

__all__ = ["CNNOnlyHWR", "CRNN", "SmallCRNN", "SpacedGenerator", "CountCNN",
           "CharStyleEncoder", "HWWithStyle"]
