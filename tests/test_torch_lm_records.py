"""The LM paths' record streams are pinned: each served step of the reduced
qwen3, zamba2, mixtral and llama4 configs, stateful and stateless, emits a
fixed number of ``kernel:`` records and no ``cudaMemcpyDtoD`` (the MoE
configs' capacity dispatch has the same operators for every token).  The
interceptor records an ``aten.clone`` of a contiguous tensor as a DtoD
copy; the LM traces' clones all read strided views (an expanded or
transposed head layout), so they stay kernels and the counts do not move."""
from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core.records import FUNC_D2D  # noqa: E402
from repro_torch.serving.engine import RRTOServedLM  # noqa: E402

# (config, reduce kwargs, stateful) -> kernel records per step
PINNED = {
    ("qwen3-0.6b", True): 240,
    ("qwen3-0.6b", False): 221,
    ("zamba2-1.2b", True): 708,
    ("zamba2-1.2b", False): 477,
    ("mixtral-8x7b", True): 307,
    ("mixtral-8x7b", False): 288,
    ("llama4-maverick-400b-a17b", True): 284,
    ("llama4-maverick-400b-a17b", False): 263,
}
REDUCE = {"qwen3-0.6b": {}, "zamba2-1.2b": dict(n_layers=5, attn_every=2),
          "mixtral-8x7b": {}, "llama4-maverick-400b-a17b": {}}


def _per_step_counts(name: str, stateful: bool):
    cfg = get_reduced_config(name, **REDUCE[name])
    served = RRTOServedLM(cfg, system="cricket", bucket_len=16, seed=1, device="cpu",
                          stateful=stateful)
    sess = served.session
    inner = sess.infer
    steps = []

    def infer(*args):
        n0 = len(sess.client.logs)
        res = inner(*args)
        steps.append(Counter(
            "kernel" if r.func.startswith("kernel:") else r.func
            for r in sess.client.logs[n0:]
        ))
        return res

    sess.infer = infer
    served.generate(np.arange(3, dtype=np.int32)[None], 3)
    return steps


@pytest.mark.parametrize("name,stateful", sorted(PINNED), ids=lambda v: str(v))
def test_lm_record_stream_is_pinned(name, stateful):
    steps = _per_step_counts(name, stateful)
    assert len(steps) == (5 if stateful else 3)
    assert [c["kernel"] for c in steps] == [PINNED[name, stateful]] * len(steps)
    assert [c[FUNC_D2D] for c in steps] == [0] * len(steps)
