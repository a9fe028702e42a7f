"""Checkpoints of flat ``{name: tensor}`` dicts (``repro.checkpoint``)."""
