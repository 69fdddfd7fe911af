"""The line-generation models: the port of
``affganwriting_tpu/models/line/``."""

from affganwriting_torch.models.line.autoencoder import Autoencoder
from affganwriting_torch.models.line.char_style import CharStyleEncoder
from affganwriting_torch.models.line.container import HWWithStyle
from affganwriting_torch.models.line.count_cnn import CountCNN
from affganwriting_torch.models.line.discriminator import DiscriminatorAP
from affganwriting_torch.models.line.hwr import CNNOnlyHWR, CRNN, SmallCRNN
from affganwriting_torch.models.line.spaced_gen import SpacedGenerator

__all__ = ["CNNOnlyHWR", "CRNN", "SmallCRNN", "SpacedGenerator", "CountCNN",
           "CharStyleEncoder", "HWWithStyle", "DiscriminatorAP",
           "Autoencoder"]
