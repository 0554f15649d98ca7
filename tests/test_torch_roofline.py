"""The port's roofline arithmetic against the reference's: ``roofline_terms``
and ``model_flops`` give the reference's numbers under the reference's
constants (the port's own are an H100's), and
``collective_bytes_from_graph`` sizes the collectives of a traced DTensor
graph by their outputs, as the reference sizes HLO collectives."""

import pytest
import torch

from repro import roofline as jroof
from repro_torch import roofline as troof
from repro_torch.launch.mesh import close_process_group, make_mesh

CASES = [
    dict(flops=3.2e15, hbm_bytes=1.1e12, collective_bytes=4.0e9),
    dict(flops=1.0e9, hbm_bytes=8.0e12, collective_bytes=0.0),
    dict(flops=5.0e12, hbm_bytes=1.0e9, collective_bytes=9.0e11),
    dict(flops=0.0, hbm_bytes=0.0, collective_bytes=0.0),
]


@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_roofline_terms_follow_the_reference(monkeypatch, case):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(troof, name, getattr(jroof, name))
    assert troof.roofline_terms(**case) == jroof.roofline_terms(**case)


def test_h100_constants():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (
        989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("n,d", [(1.24e9, 8 * 2048), (6.9e9, 1.0), (0, 5)])
def test_model_flops_follow_the_reference(n, d):
    assert troof.model_flops(n, d) == jroof.model_flops(n, d)


@pytest.fixture
def fake_mesh_2x2():
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu",
                     backend="fake")
    yield mesh
    close_process_group()


def test_collective_bytes_from_a_traced_graph(fake_mesh_2x2):
    """All-gathering a (8, 6) float32 DTensor sharded over ``data`` to
    replicated, and reducing a partial sum over ``model``: one all-gather
    of the full 8·6·4 bytes, one all-reduce of a (3, 6) float32 block."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.fx.experimental.proxy_tensor import make_fx

    mesh = fake_mesh_2x2

    def f(a_local, b_local):
        a = DTensor.from_local(a_local, mesh, [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(b_local, mesh, [Replicate(), Partial()],
                               run_check=False)
        return (a.redistribute(mesh, [Replicate(), Replicate()]).to_local(),
                b.redistribute(mesh, [Replicate(), Replicate()]).to_local())

    gm = make_fx(f)(torch.zeros(4, 6), torch.zeros(3, 6))
    got = troof.collective_bytes_from_graph(gm)
    assert got == {"bytes_by_kind": {"all-gather": 8 * 6 * 4,
                                     "all-reduce": 3 * 6 * 4},
                   "counts": {"all-gather": 1, "all-reduce": 1},
                   "total_bytes": 8 * 6 * 4 + 3 * 6 * 4}
