"""The fused scan kernel as compiled for the GPU. These tests need a card:
they skip elsewhere, and run on one with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernel.py
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coltt_tpu.ops import scan_pallas
from coltt_tpu.ops.distance import Metric
from coltt_tpu.ops.quant import Quantization, dequantize, quantize
from coltt_tpu.ops.topk import scan_topk

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the kernel compiles through Triton there")
    return jax.devices()[0]


def _store(n=1 << 17, d=768, quant=Quantization.I8):
    """A cluster-mixture corpus (32 rows per center, in random row order so
    a cluster does not fill one bin): true neighbours stand clear of the
    rest, so rankings compare without near-ties."""
    kc, kp, kn = jax.random.split(jax.random.PRNGKey(0), 3)
    centers = jax.random.normal(kc, (n // 32, d), jnp.float32)
    assign = jax.random.permutation(kp, n) // 32
    vecs = centers[assign] + 0.35 * jax.random.normal(kn, (n, d), jnp.float32)
    codes, scale = quantize(vecs, quant)
    deq = dequantize(codes, scale)
    return vecs, codes, scale, jnp.sum(deq * deq, axis=1)


@pytest.mark.parametrize("quant", [Quantization.I8, Quantization.F8])
def test_compiled_search_calls_the_triton_kernel(gpu, quant):
    _, codes, scale, sqnorm = _store(quant=quant)
    valid = jnp.ones((codes.shape[0],), bool)
    txt = jax.jit(partial(scan_pallas.fused_scan_topk, k=10)).lower(
        jnp.zeros((64, codes.shape[1])), codes, scale, sqnorm, valid,
    ).compile().as_text()
    assert "__gpu$xla.gpu.triton" in txt
    assert scan_pallas.KERNEL_NAME in txt


# the engine's pairings: I8 cosine (per-query int8 queries on both paths)
# and F8 euclidean (bf16 on both); I8 euclidean shares one query scale
# across the batch in the kernel only, so its rankings differ by design
@pytest.mark.parametrize("metric, quant", [
    (Metric.COSINE, Quantization.I8), (Metric.EUCLIDEAN, Quantization.F8),
])
def test_compiled_kernel_matches_xla_scan(gpu, metric, quant):
    vecs, codes, scale, sqnorm = _store(quant=quant)
    valid = jnp.ones((codes.shape[0],), bool)
    q = vecs[::2048] + 0.1  # 64 queries near stored rows
    _, i_fused = scan_pallas.fused_scan_topk(
        q, codes, scale, sqnorm, valid, k=10, metric=metric)
    _, i_xla = scan_topk(q, codes, scale, sqnorm, valid, k=10, metric=metric)
    overlap = np.mean([
        len(set(a) & set(b)) / 10
        for a, b in zip(np.asarray(i_fused), np.asarray(i_xla))
    ])
    assert overlap >= 0.98
