"""The port stands alone: it imports neither JAX nor anything of the JAX
package, so it runs where JAX is not installed."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b|import repro\.)",
                       re.M)

SCRIPT = """
import sys
import numpy as np
import repro_torch.configs, repro_torch.convert, repro_torch.core.offload
import repro_torch.kernels.library
from repro_torch.core.offload import OffloadSession
from repro_torch.models.cnn_zoo import make_kapao_calibrated
kapao = make_kapao_calibrated(0.125, 256, device="cpu")
sess = OffloadSession(kapao, "rrto", device="cpu")
assert [sess.infer(*kapao.example_inputs).rpcs for _ in range(5)][-1] == 11
from repro_torch.configs import get_reduced_config
from repro_torch.serving.engine import LocalServing, RRTOServedLM
cfg = get_reduced_config("qwen3-0.6b")
prompt = np.arange(4, dtype=np.int32)[None]
a = RRTOServedLM(cfg, bucket_len=12, seed=1, device="cpu").generate(prompt, 5).tokens
b = LocalServing(cfg, seed=1, device="cpu").generate({"tokens": prompt}, 5).tokens
assert (a == b).all(), (a, b)
import repro_torch.serving.multitenant, repro_torch.serving.replay_cache
from repro_torch.core.engine import no_vmap_fallback
from repro_torch.serving.engine import MultiClientServedLM
two = MultiClientServedLM(cfg, 2, bucket_len=12, seed=1, device="cpu")
with no_vmap_fallback():
    c = two.generate([prompt, prompt[:, :3]], 5)
assert (c[0].tokens == a).all(), (c[0].tokens, a)
assert two.edge.compile_count == 1 and two.edge.batcher.vmap_batches >= 1
import repro_torch.partition
from repro_torch.models.cnn_zoo import make_sensor_encoder
from repro_torch.partition import PartitionConfig
enc = make_sensor_encoder(0.25, 32, n_blocks=2, device="cpu")
split = OffloadSession(enc, "rrto", min_repeats=2, device="cpu",
                       partition=PartitionConfig(pipelined=True))
res = [split.infer(*enc.example_inputs) for _ in range(4)]
assert res[-1].mode == "replaying" and split.client.split_plan is not None
streamed = split.infer_stream([tuple(enc.example_inputs)] * 2)
assert all(bool((s.outputs[0] == res[-1].outputs[0]).all()) for s in streamed)
import repro_torch.checkpoint.store, repro_torch.distributed.straggler
import repro_torch.serving.fleet, repro_torch.serving.recovery
from repro_torch.serving import EdgeFleet
fleet = EdgeFleet(2, device="cpu")
lm = RRTOServedLM(cfg, bucket_len=12, seed=1, edge=fleet.replicas[0].edge, client_id="u0")
g = lm.start_generation(prompt, 5)
for step in range(lm.steps_total(g)):
    if step == 6:
        assert fleet.migrate("u0") == "r1"
    lm.absorb_step(g, lm.session.infer(*lm.step_inputs(g)).outputs)
assert fleet.stats.migrations == 1 and lm.session.client.stateful_replay
assert (np.concatenate(g["out"], axis=1) == a).all(), (g["out"], a)
import repro_torch.serving.admission
from repro_torch.serving.admission import AdmissionController, AdmissionRejectedError, SLOClass
adm = AdmissionController(rate_hz=1e-6, burst=0.0, default_class=SLOClass(deadline_s=1e9))
lm.session.admission = adm
adm.register("u0")
try:
    lm.session.infer(*lm.step_inputs(g))
    raise SystemExit("a stateful step under a zero-capacity controller was not shed")
except AdmissionRejectedError as e:
    assert e.retry_after_s > 0 and adm.stats.shed == 1
import json, os, tempfile
import repro_torch.obs
from repro_torch.obs import Tracer, write_chrome_trace
tracer = Tracer()
traced = EdgeFleet(2, tracer=tracer, device="cpu")
tlm = RRTOServedLM(cfg, bucket_len=12, seed=1, edge=traced.replicas[0].edge, client_id="u0")
tg = tlm.start_generation(prompt, 5)
for step in range(tlm.steps_total(tg)):
    if step == 6:
        traced.migrate("u0")
    tlm.absorb_step(tg, tlm.session.infer(*tlm.step_inputs(tg)).outputs)
assert (np.concatenate(tg["out"], axis=1) == a).all(), (tg["out"], a)
assert traced.metrics.snapshot()["fleet.migrations"] == 1
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "trace.json")
    write_chrome_trace(tracer, path)
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
assert {"record_rpc", "replay_call", "migrate", "state_transfer"} <= names, names
import repro_torch.analysis, repro_torch.analysis.__main__
from repro_torch.analysis import ReplaySoundnessError, verify_ios
verified = OffloadSession(enc, "rrto", min_repeats=2, device="cpu", verify=True)
assert [verified.infer(*enc.example_inputs) for _ in range(3)][-1].mode == "replaying"
report = verify_ios("sensor_encoder", verified.client._ios_calls)
assert report.ok and report.census["n_kernels"] > 0, report.as_dict()
import repro_torch.training.data, repro_torch.training.losses, repro_torch.training.optimizer
import repro_torch.training.step, repro_torch.launch.train
from repro_torch.configs.base import ShapeConfig
from repro_torch.training.data import DataConfig, synth_batch
from repro_torch.training.step import init_train_state, make_train_step
params, opt = init_train_state(cfg, seed=0, device="cpu")
batch = synth_batch(cfg, ShapeConfig("iso", 16, 2, "train"), 0, DataConfig())
params, opt, metrics = make_train_step(cfg)(params, opt, batch)
assert int(metrics["step"]) == 1 and np.isfinite(float(metrics["loss"])), metrics
bad =sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro")
print("LOADED", bad)
"""


def test_no_jax_or_repro_modules_loaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_sources_import_no_jax_or_repro(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path
