"""The port's topology solver (dnet_tpu_torch/parallel/solver.py) against
the reference's: on seeded device sets the greedy solve, the HiGHS MILP and
`solve_topology` give the same assignments, layers, rounds, window,
residency, mesh axes, k and solver name; `model_profile_from_checkpoint`
gives the same cost model from the checkpoint headers; and the device
profile carries the reference's keys."""

import dataclasses

import numpy as np
import pytest

import dnet_tpu.core.types as ref_types
import dnet_tpu.parallel.solver as ref_solver
import dnet_tpu_torch.core.types as port_types
import dnet_tpu_torch.parallel.solver as port_solver

pytestmark = pytest.mark.parallel

GB = 1024**3


def _devices(kind: str, seed: int) -> list:
    """Seeded DeviceInfo field sets: `homogeneous` (one kind of device),
    `heterogeneous` (rates and memory spread 4x: the MILP's regime),
    `too_small` (one device cannot hold a layer), `streamed` (memory holds
    a fraction of the model: k > 1 rounds)."""
    rng = np.random.default_rng(seed)
    n = 2 if kind == "streamed" else int(rng.integers(2, 6))
    rows = []
    for i in range(n):
        row = dict(instance=f"d{i}", host=f"h{i % 2}", http_port=80 + i, grpc_port=50 + i, slice_id=i % 2,
                   chip_kind="gpu", hbm_bytes=16 * GB, host_ram_bytes=64 * GB, flops_bf16=200e12, hbm_bw=800e9,
                   host_to_hbm_bw=10e9, t_comm=0.0)
        if kind == "heterogeneous":
            f = float(rng.uniform(0.25, 1.0))
            row.update(flops_bf16=200e12 * f, hbm_bw=800e9 * f, hbm_bytes=int(16 * GB * rng.uniform(0.5, 1.5)),
                       t_comm=float(rng.uniform(0.0, 2e-3)))
        elif kind == "too_small" and i == n - 1:
            row.update(hbm_bytes=int(1.2 * GB), host_ram_bytes=1 * GB)
        elif kind == "streamed":
            row.update(hbm_bytes=int(GB * rng.uniform(4.5, 5.5)), host_ram_bytes=64 * GB)
        rows.append(row)
    return rows


def _profile(mod, kind: str):
    layers = 16 if kind == "streamed" else 32
    layer_mb = 1024 if kind == "streamed" else 400
    return mod.ModelProfile(model_id="m", num_layers=layers, layer_bytes=layer_mb * 1024 * 1024,
                            layer_flops_per_token=layer_mb * 1024 * 1024, kv_bytes_per_token_per_layer=4096,
                            edge_bytes=GB // 2 if kind != "streamed" else 0,
                            seq_len=1024 if kind == "streamed" else 4096, tp_heads=8, hidden_bytes=8192)


def _topo_view(topo) -> dict:
    return {
        "model": topo.model, "num_layers": topo.num_layers, "kv_bits": topo.kv_bits,
        "devices": [(d.instance, d.chip_count) for d in topo.devices],
        "assignments": [(a.instance, a.layers, a.rounds, a.next_instance, a.window_size, a.residency_size,
                         a.mesh_tp, a.mesh_sp, a.tp_degree) for a in topo.assignments],
        "solution": topo.solution,
    }


def _solve(kind: str, seed: int, fn: str, **kw):
    out = []
    for types_mod, solver in ((ref_types, ref_solver), (port_types, port_solver)):
        devs = [types_mod.DeviceInfo(**row) for row in _devices(kind, seed)]
        try:
            res = getattr(solver, fn)(devs, _profile(solver, kind), **kw)
        except ValueError as exc:
            out.append(("ValueError", str(exc)))
            continue
        out.append(_topo_view(res) if fn == "solve_topology" else dataclasses.asdict(res))
    return out


KINDS = ["homogeneous", "heterogeneous", "too_small", "streamed"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn", ["solve_greedy", "solve_milp"])
def test_solves_equal_the_reference(kind, seed, fn):
    ref, port = _solve(kind, seed, fn)
    assert port == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("solver", ["auto", "greedy", "milp"])
def test_solve_topology_equals_the_reference(kind, seed, solver):
    ref, port = _solve(kind, seed, "solve_topology", solver=solver, kv_bits=8 if seed == 2 else 0)
    assert port == ref
    if kind == "streamed" and isinstance(port, dict):
        assert port["solution"]["k"] > 1  # the fully streamed set deals rounds
    if isinstance(port, dict):
        covered = sorted(x for a in port["assignments"] for x in a[1])
        assert covered == list(range(port["num_layers"]))


@pytest.mark.parametrize("family", ["llama", "mixtral", "qwen3_moe"])
@pytest.mark.parametrize("opts", [{}, {"kv_bits": 8, "seq_len": 256}, {"weight_quant_bits": 4}])
def test_model_profile_from_checkpoint_equals_the_reference(family, opts, tmp_path_factory):
    from tests.fakes import checkpoints

    model_dir = tmp_path_factory.mktemp(family)
    getattr(checkpoints, f"make_tiny_{family}")(model_dir)
    port = port_solver.model_profile_from_checkpoint(model_dir, **opts)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref_solver.model_profile_from_checkpoint(model_dir, **opts))
    assert port.layer_bytes > 0 and port.edge_bytes > 0


def test_cpu_profile_has_the_reference_keys():
    from dnet_tpu.parallel.profiler import profile_device_quick
    from dnet_tpu_torch.parallel.profiler import profile_device

    port = profile_device("cpu")
    ref = profile_device_quick()
    assert list(port) == list(ref)
    assert all(port[k] > 0 for k in ("flops_bf16", "hbm_bw", "host_to_hbm_bw", "host_ram_bytes"))
    assert (port["device_kind"], port["platform"], port["local_device_count"], port["hbm_bytes"]) == (
        "cpu", "cpu", 1, 0)
