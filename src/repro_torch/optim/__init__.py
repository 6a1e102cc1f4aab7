"""Optimizer of the port's LM trainer: AdamW with the reference's schedule,
clip and decay (``adamw``), and count-sketch gradient compression with
error feedback (``grad_compress``), whose sketches run the count_sketch
kernel on the card."""
from . import adamw
from .grad_compress import CountSketchCompressor

__all__ = ["CountSketchCompressor", "adamw"]
