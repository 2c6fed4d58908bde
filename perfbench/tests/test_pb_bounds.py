"""The benchmark's bound arithmetic at the shapes of PERF.md's kernel
table (H100 SXM: 3.35 TB/s, 67 Tflop/s float32, 33.5 Tops/s int32)."""
import pytest

from perfbench import bounds as B

MS = 1e-3


@pytest.mark.parametrize("got, want_ms", [
    (lambda: B.fused_score(64, 100_000, 6_400_000, 50, 5), 0.1707),
    (lambda: B.fused_score(64, 64 * 4096, 64 * 4096, 50, 5), 0.0103),
    (lambda: B.fused_score(64, 100_000, 6_400_000, 50, 5, num_bytes=1), 0.1727),
    (lambda: B.fused_score(64, 64 * 2048, 64 * 2048, 50, 5, num_bytes=1), 0.0035),
    (lambda: B.lsh_probe(64, 100_000, 64), 0.0245),
    (lambda: B.lsh_probe(64, 100_000, 16), 0.0096),
    (lambda: B.lsh_probe_indexed(64, 2048, 64, 12_064), 0.0014),
    (lambda: B.topk(64, 100_000, 10), 0.0076),
    (lambda: B.topk(64, 100_000, 4096), 0.0083),
    (lambda: B.topk(64, 4_194_304, 100), 0.3205),
    (lambda: B.topk(64, 2048, 2048), 0.0005),
])
def test_bounds_at_the_kernel_table_shapes(got, want_ms):
    assert got() / MS == pytest.approx(want_ms, abs=5e-5)


def test_plan_bounds_sum_their_stages():
    from perfbench import harness
    q, n = 256, 1 << 20
    plans = {c["name"]: harness.load_config(c) for c in harness.load_manifest()["configs"]}
    full, tiered = plans["full1m"], plans["tiered4m"]
    want = B.fused_score(q, n, q * n, 50, 5) + B.elementwise(q * n, 8) + B.topk(q, n, 10)
    assert harness.load_plan(full).bound_s(q, n, full, 50, 5) == pytest.approx(want)
    # the scorer's int32 work bounds it: 722 int32 and 343 float32 ops a pair
    assert B.fused_score(q, n, q * n, 50, 5) == pytest.approx(
        q * n * 343 / B.F32_OPS + q * n * 722 / B.I32_OPS)
    t = harness.load_plan(tiered).bound_s(q, 4 * n, tiered, 50, 5)
    assert B.lsh_probe(q, 4 * n, 16) + B.topk(q, 4 * n, 2048) < t < 0.02
