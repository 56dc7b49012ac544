"""The slice end to end at tiny shapes: the port's ``entry`` render against
the JAX ``BAPipeline`` render of ``__graft_entry__._flagship(tiny=True)``
(camera 0, channels rgb/depth/semantics/inst_embedding), same converted
parameters, on the CPU.

float32 decoders: atol 1e-4 (float32 rounding of reordered sums and of
exp/sigmoid). bfloat16 decoders (the flagship setting): atol 5e-4, because
XLA's dot_general and torch's matmul round the bf16 products and sums at
different points; each such difference is one bf16 ulp (2^-8 relative) of a
hidden unit, and the channels are integrals of many samples of them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pagnerf_tpu.core.rays import Rays as RaysJ
from pagnerf_tpu.ops.occupancy import OccupancyGrid as OccJ
from pagnerf_tpu_torch import entry as entry_t
from pagnerf_tpu_torch.convert import params_from_flax

CHANNELS = ("rgb", "depth", "semantics", "inst_embedding")


def _jax_render(compute_dtype_name):
    pipe, ds = graft._flagship(tiny=True)
    pipe.nef = pipe.nef.clone(compute_dtype_name=compute_dtype_name)
    params = pipe.init(jax.random.PRNGKey(0))
    occ = OccJ.create(level=7)
    base = ds.data["base_rays_dirs"].reshape(-1, 3)
    n = min(4096, base.shape[0])

    def fn(params, origins, dirs, cam_idx):
        rays = RaysJ(origins=origins, dirs=dirs, dist_min=jnp.float32(0.0),
                     dist_max=jnp.float32(6.0))
        rb = pipe(params, rays, frozenset(CHANNELS), occ, cam_idx=cam_idx)
        return rb.rgb, rb.depth, rb.semantics, rb.inst_embedding

    out = jax.jit(fn)(params, jnp.zeros((1, n, 3), jnp.float32),
                      jnp.asarray(base[None, :n], jnp.float32),
                      jnp.zeros((1,), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params), [np.asarray(o) for o in out]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-4)],
                         ids=["float32", "bfloat16"])
def test_entry_render_matches_jax(dtype, atol):
    params, ref = _jax_render("float32" if dtype == torch.float32 else "bfloat16")
    fn, (pipe, origins, dirs, cam_idx) = entry_t.entry(
        device="cpu", tiny=True, compute_dtype=dtype)
    pipe.load_state_dict(params_from_flax(params))
    out = fn(pipe, origins, dirs, cam_idx)
    for ch, got, want in zip(CHANNELS, out, ref):
        assert tuple(got.shape) == want.shape, ch
        assert bool(torch.isfinite(got).all()), ch
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol,
                                   err_msg=ch)


def test_rgb_depth_render_takes_single_gather_path():
    fn, args = entry_t.entry(device="cpu", tiny=True)
    full = fn(*args)
    rd = fn(*args, channels=frozenset({"rgb", "depth"}))
    assert rd[2] is None and rd[3] is None
    # the dual gather is bit-exact against the single one, so rgb/depth agree
    assert torch.equal(rd[0], full[0]) and torch.equal(rd[1], full[1])


def test_flagship_shapes_and_state_names():
    pipe, ds = entry_t.flagship(tiny=True, device="cpu")
    ref_pipe, _ = graft._flagship(tiny=True)
    ref = ref_pipe.init(jax.random.PRNGKey(0))
    flat = params_from_flax(jax.tree_util.tree_map(np.asarray, ref))
    state = pipe.state_dict()
    assert sorted(state) == sorted(flat)
    for k, v in flat.items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    np.testing.assert_allclose(state["extrinsics"].numpy(),
                               np.asarray(ref["extrinsics"]), atol=1e-7)
    assert ds.semantic_info["num_instances"] == pipe.nef.num_instances


def test_seeded_entry_is_reproducible():
    a = entry_t.entry(device="cpu", tiny=True, seed=3)
    b = entry_t.entry(device="cpu", tiny=True, seed=3)
    for x, y in zip(a[0](*a[1]), b[0](*b[1])):
        assert torch.equal(x, y)
