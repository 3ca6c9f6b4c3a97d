"""The port's `data/rand_augment.py` against the JAX package on the CPU
(the cases of `tests/test_rand_augment.py`).

Each op at fixed arguments on a seeded [2, 16, 16, 3] clip in [0, 1]
against the JAX op (1e-6; `equalize` and `posterize` exactly, as their
quantisation steps would otherwise hide an off-by-one bin). The random
draws come from a `torch.Generator`, not from JAX keys, so RandAugment as a
whole is held by its contract: deterministic per generator state, varied
per sample and per seed, shapes and range kept; the PCA lighting against
its formula on the generator's own draws; the short-cycle batch sampler
against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mspi_tpu.data import rand_augment as jax_ra
from mspi_tpu.train.multigrid import short_cycle_batches as jax_short_cycle_batches
from mspi_tpu_torch.data import rand_augment as ra
from mspi_tpu_torch.train.multigrid import short_cycle_batches
from tests.torch_port_utils import cpu_share  # noqa: F401

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

OPS = [("rotate", 15.0), ("rotate", -27.0), ("shear_x", 0.2), ("shear_y", -0.25),
       ("translate_x", 0.3), ("translate_y", -0.2), ("brightness", 1.4), ("contrast", 0.6),
       ("saturation", 1.5), ("posterize", 4.0), ("solarize", 0.5), ("solarize_add", 0.2),
       ("invert", None), ("autocontrast", None), ("equalize", None), ("sharpness", 1.8),
       ("sharpness", 0.3),
       # the ends of `_ops`' ranges (magnitude 10, either sign) and the identities
       ("rotate", 30.0), ("shear_x", -0.3), ("shear_y", 0.3), ("translate_x", -0.45),
       ("translate_y", 0.45), ("brightness", 0.1), ("contrast", 1.9), ("saturation", 0.1),
       ("posterize", 8.0), ("posterize", 1.0), ("solarize", 0.0), ("solarize_add", 0.5)]
EXACT = ("equalize", "posterize")


def _clip(rng, T=2, H=16, W=16):
    return rng.random((T, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("name,arg", OPS)
def test_op_matches_jax(rng, name, arg):
    """The op against JAX's at the same argument; shape and [0, 1] kept."""
    clip = _clip(rng)
    want = np.asarray(getattr(jax_ra, name)(jnp.asarray(clip), arg))
    got = getattr(ra, name)(torch.from_numpy(clip), arg).numpy()
    assert got.shape == clip.shape and got.dtype == np.float32
    assert np.all(got >= -1e-6) and np.all(got <= 1 + 1e-6) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0 if name in EXACT else 1e-6)


def test_rotate_identity_and_translate():
    clip = torch.zeros((1, 8, 8, 3))
    clip[:, 2, 3] = 1.0
    torch.testing.assert_close(ra.rotate(clip, 0.0), clip, rtol=0, atol=1e-6)
    torch.testing.assert_close(ra.translate_y(clip, 0.0), clip, rtol=0, atol=1e-6)
    # two pixels right: the inverse map pulls from x - 2; the border fills with 0.5
    shifted = ra.translate_x(clip, -2 / 8)
    assert shifted[0, 2, 5].eq(1.0).all() and shifted[0, 0, 0].eq(0.5).all()


def test_rand_augment_batch_deterministic_and_varied(rng):
    clips = torch.from_numpy(rng.random((3, 2, 16, 16, 3)).astype(np.float32))
    a = ra.rand_augment_batch(torch.Generator().manual_seed(7), clips, 2, 9)
    b = ra.rand_augment_batch(torch.Generator().manual_seed(7), clips, 2, 9)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == clips.shape and torch.isfinite(a).all()
    assert a.min() >= 0.0 and a.max() <= 1.0
    c = ra.rand_augment_batch(torch.Generator().manual_seed(8), clips, 2, 9)
    assert not torch.allclose(a, c)
    d = a - clips
    assert not torch.allclose(d[0], d[1])


def test_ops_share_the_saturation_and_sharpness_sign():
    """`_ops`' arguments at magnitude 5: the JAX table's, with sign draw 7
    shared by saturation and sharpness."""
    for signs in ([True] * 8, [False] * 8, [i % 2 == 0 for i in range(8)]):
        table = {name: arg for name, _, arg in ra._ops(signs, 5.0)}
        assert table["saturation"] == table["sharpness"] == 1.0 + (0.45 if signs[7] else -0.45)
        assert table["rotate"] == (15.0 if signs[0] else -15.0)
        assert table["posterize"] == 6.0 and table["solarize"] == 0.5
    assert [n for n, _, _ in ra._ops([True] * 8, 5.0)] == \
        [n for n, _, _ in jax_ra._ops(jax.random.PRNGKey(0), 5.0)]


def test_color_jitter_and_lighting(rng):
    clips = torch.from_numpy(rng.random((2, 2, 8, 8, 3)).astype(np.float32))
    out = ra.color_jitter_batch(torch.Generator().manual_seed(0), clips)
    assert out.shape == clips.shape and not torch.allclose(out, clips)
    assert out.min() >= 0.0 and out.max() <= 1.0
    eigval = [0.225, 0.224, 0.229]
    eigvec = np.eye(3).tolist()
    lit = ra.lighting_batch(torch.Generator().manual_seed(1), clips, eigval, eigvec)
    assert lit.shape == clips.shape and lit.min() >= 0 and lit.max() <= 1
    alpha = 0.1 * torch.randn((2, 3), generator=torch.Generator().manual_seed(1))
    delta = (torch.tensor(eigvec)[None] * (alpha * torch.tensor(eigval))[:, None, :]).sum(-1)
    torch.testing.assert_close(lit, (clips + delta[:, None, None, None, :]).clamp(0, 1),
                               rtol=0, atol=1e-7)


def test_short_cycle_batches():
    """The multigrid short cycle (crops 112 / 152 / 224 at batch sizes 16
    / 8 / 4), its batches equal to JAX's unshuffled."""
    batches = list(short_cycle_batches(100, base_batch=4, base_crop=224, shuffle=False))
    want = list(jax_short_cycle_batches(100, base_batch=4, base_crop=224, shuffle=False))
    assert [(list(i), c) for i, c in batches] == [(list(i), c) for i, c in want]
    assert [c for _, c in batches[:3]] == [112, 152, 224]
    sizes = [len(i) for i, _ in batches[:3]]
    assert sizes[0] > sizes[1] > sizes[2] == 4
    seen = np.concatenate([i for i, _ in batches])
    assert len(seen) == len(set(seen.tolist()))
