"""Distributed serving tools (``repro.distributed``): the hedged router."""
