"""Distributed tools (``repro.distributed``): the hedged router and the
training straggler policy, the sharding layer and the int8 compressed
all-reduce."""
