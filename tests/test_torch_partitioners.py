"""Device routing of rows outside the domain: the port's ``partition_ids``
against the JAX package's compiled ``partition_ids`` on ±inf, NaN, ±1e30,
``-0.0`` and first coordinates whose quotient passes the int32 range, and
the device-ingest engine on such rows against the JAX engine (published
bytes). XLA's float-to-int convert saturates (NaN to 0); the port clamps in
float32 before its cast, so both send +inf and huge quotients to partition
P - 1. Exact comparisons, no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyline_tpu.parallel.partitioners import partition_ids as j_partition_ids
from skyline_tpu.stream import EngineConfig as JaxConfig
from skyline_tpu.stream import SkylineEngine as JaxEngine
from skyline_tpu_torch.parallel.partitioners import mr_angle, mr_dim, partition_ids
from skyline_tpu_torch.stream import EngineConfig, SkylineEngine

torch.set_num_threads(1)

F32 = np.float32
DOMAIN = 10000.0
_j_ids = jax.jit(j_partition_ids, static_argnums=(1, 2, 3))


def outside_rows(rng, d: int) -> np.ndarray:
    """Rows in the domain mixed with every value outside it, in the first
    coordinate and elsewhere: ±inf, NaN, ±1e30, -0.0, quotients at and past
    2^31 (first coordinates up to 1e13 at a partition width of 1,250), the
    f32 maximum."""
    special = np.array([np.inf, -np.inf, np.nan, 1e30, -1e30, -0.0, 0.0, 3e12, 2.7e12,
                        1e13, -1e13, np.finfo(F32).max, 9999.0, 10000.0, 5000.0], F32)
    x = (rng.random((400, d)) * DOMAIN).astype(F32)
    x[:200] = special[rng.integers(0, special.size, size=(200, d))]
    x[200:260, 0] = special[rng.integers(0, special.size, size=60)]
    return x


@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("algo", ["mr-dim", "mr-grid", "mr-angle"])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_partition_ids_outside_the_domain_match_jax(rng, d, algo, P):
    x = outside_rows(rng, d)
    want = np.asarray(_j_ids(jnp.asarray(x), algo, P, DOMAIN))
    got = partition_ids(torch.from_numpy(x), algo, P, DOMAIN)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_mr_dim_saturates_like_xla():
    """+inf and quotients past 2^31 to the last partition, -inf and NaN to
    the first (the rows of the fault that the float clamp repaired)."""
    x = torch.tensor([[np.inf], [1e30], [2.7e12], [-np.inf], [np.nan], [-1e30], [-0.0],
                      [9999.0]], dtype=torch.float32)
    assert mr_dim(x, 8, DOMAIN).tolist() == [7, 7, 7, 0, 0, 0, 0, 7]


def test_mr_angle_casts_already_agree():
    """mr-angle needs no repair: ``atan2`` of a non-negative norm lies in
    [0, pi], so the scaled angle stays far inside the int32 range, and a NaN
    row gives 0 after the clamp whether the cast saturates (XLA, the card)
    or wraps to INT32_MIN (torch on the CPU). Both casts (d = 2 and d > 2)."""
    rows = np.array([[np.nan, 1, 1], [1, np.nan, 1], [np.inf, 1, 1], [-np.inf, 1, 1],
                     [1, np.inf, np.inf], [-1e30, 1e30, 0], [0, 0, 0], [-0.0, 5, 5]], F32)
    for x in (rows, rows[:, :2]):
        for P in (1, 4, 8):
            got = mr_angle(torch.from_numpy(x), P, DOMAIN)
            want = np.asarray(_j_ids(jnp.asarray(x), "mr-angle", P, DOMAIN))
            assert np.array_equal(got.numpy(), want)
            assert ((got >= 0) & (got < P)).all()


def _publish(eng, rows):
    eng.process_records(np.arange(len(rows), dtype=np.int64), rows)
    eng.process_trigger("q,0")
    out = eng.poll_results()
    assert len(out) == 1
    return out[0]


# the smallest input that showed the fault: a quotient of 1e30 / 5000
FAULT_ROWS = np.array([[1e30, 0, 1], [1, 1, 0], [9000, 0.5, 0.5]], F32)


@pytest.mark.parametrize("policy", ["lazy", "overlap"])
@pytest.mark.parametrize("case", ["fault", "outside"])
def test_device_engine_routes_outside_rows_like_jax(policy, case):
    """ROADMAP queue 3's input (``parallelism=1``, mr-dim, device ingest),
    then rows outside the domain at ``parallelism=4``: the published points
    in the JAX engine's order, byte for byte."""
    if case == "fault":
        rows, par = FAULT_ROWS, 1
    else:
        rows, par = outside_rows(np.random.default_rng(7), 3), 4
    common = dict(parallelism=par, algo="mr-dim", dims=3, domain_max=DOMAIN,
                  emit_skyline_points=True, flush_policy=policy, ingest="device")
    want = _publish(JaxEngine(JaxConfig(**common)), rows)
    got = _publish(SkylineEngine(EngineConfig(**common, device="cpu")), rows)
    assert got["skyline_size"] == want["skyline_size"]
    pw = np.asarray(want["skyline_points"], F32)
    pg = np.asarray(got["skyline_points"], F32)
    assert pg.tobytes() == pw.tobytes()
    if case == "fault":
        assert pg.tolist() == FAULT_ROWS[[1, 2, 0]].tolist()
