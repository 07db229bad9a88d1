"""ROADMAP C4's one-step check (``chip_smoke.one_step_readings``), on the
CPU: from a run's state before each step, that one step again, every
leaf held against the run's own next state at the per-leaf bar. CPU
against CPU it reads exactly 0 on every step; a state moved by one bar at
one entry reads above 1 at that leaf, so the check names the leaf the
card would get wrong."""
import dataclasses
import functools

import pytest
import torch

import chip_smoke as cs
from repro_torch import _tree
from repro_torch.configs import smoke_config
from repro_torch.configs.base import SMOKE_MESH, ShapeConfig, TrainConfig
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.step_builders import bundle_for
from repro_torch.models import build_model

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small steps on one thread: torch's default threads crawl when the
    cores are shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def run(arch):
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              param_dtype="float32")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    bundle = bundle_for("train", cfg, ShapeConfig("t", 16, 4, "train"),
                        make_smoke_mesh("cpu"), SMOKE_MESH, tcfg)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(17))
    batches = cs.smoke_batches(cfg, STEPS, 4, 16, 18)
    states, _ = cs.train_steps(bundle, params, tcfg, batches, "cpu")
    return bundle, states, batches


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "zamba2-1.2b"])
def test_one_step_reads_zero_cpu_against_cpu(arch):
    bundle, states, batches = run(arch)
    assert len(states) == STEPS + 1
    readings = cs.one_step_readings(bundle.model.cfg, bundle, states,
                                    batches, "cpu", 1e-4,
                                    cs.ONE_STEP_WIDE[arch])
    assert [r["step"][0] for r in readings] == [0.0] * STEPS
    # the gradient is the CPU's own: its f32 reading against f64, twice
    for r in readings:
        assert r["grad"] == r["cpu"] and r["grad"][0] < 1.0


def test_one_step_names_the_leaf_that_differs():
    bundle, states, batches = run("llama-3.2-vision-11b")
    states = list(states)
    path = ("seg0", "b1_self", "attn", "wo")
    params, opt = states[2]
    wo = params["seg0"]["b1_self"]["attn"]["wo"]
    moved = wo.clone()
    moved.view(-1)[0] += 2e-4 * float(wo.abs().max())
    params = _tree.map(lambda x: x, params)
    params["seg0"]["b1_self"]["attn"]["wo"] = moved
    states[2] = (params, opt)
    readings = cs.one_step_readings(bundle.model.cfg, bundle, states,
                                    batches, "cpu", 1e-4)
    assert readings[0]["step"][0] == 0.0
    share, where = readings[1]["step"]
    assert share > 1.0 and where == "/".join(path)
