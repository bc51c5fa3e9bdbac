"""Sentence encoders of the port: BERT-family forward in PyTorch, every
layer through the encoder-layer kernel on the card."""

from sema_tpu_torch.models.registry import ENCODERS, EncoderSpec, get_spec
from sema_tpu_torch.models.encoder import EncodedBatch, Encoder

__all__ = ["ENCODERS", "EncoderSpec", "get_spec", "Encoder", "EncodedBatch"]
