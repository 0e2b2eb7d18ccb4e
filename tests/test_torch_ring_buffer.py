"""The PyTorch port's batched ring buffer == the JAX package's (tolerance 0).

webrtc_aecm_tpu_torch/ops/ring_buffer.py `write`, `read` and
`move_read_ptr` on a batch of int16 jitter rings against `jax.vmap` of
webrtc_aecm_tpu/ops/ring_buffer.py's per-ring functions (whose data passes
take their plain reference off the TPU), over seeded random sequences
that fill the rings until writes clamp (down to zero samples), wrap, stuff
the read pointer backwards, and bring pointers to rest exactly at the
capacity.  On CPU tensors the ring_write / ring_gather wrappers take their
plain versions and count no kernel launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webrtc_aecm_tpu.ops import ring_buffer as jrb
from webrtc_aecm_tpu_torch.ops import ring_buffer as trb, ring_kernels

torch.set_num_threads(1)

B, CAP = 6, 4000


@pytest.fixture(scope="module")
def jax_ops():
    return {
        "write160": jax.jit(jax.vmap(jrb.write)),
        "write80": jax.jit(jax.vmap(jrb.write)),
        "read": jax.jit(jax.vmap(lambda rb: jrb.read(rb, 80))),
        "move": jax.jit(jax.vmap(jrb.move_read_ptr)),
    }


def _assert_same(t_rb, j_rb, where):
    for f in trb.RingBuffer._fields:
        np.testing.assert_array_equal(getattr(t_rb, f).numpy(),
                                      np.asarray(getattr(j_rb, f)),
                                      err_msg=f"{where}: {f}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sequence_matches_jax(jax_ops, seed):
    rng = np.random.default_rng(seed)
    data0 = rng.integers(-32768, 32768, (B, CAP)).astype(np.int16)
    j_rb = jrb.RingBuffer(jnp.asarray(data0), jnp.zeros(B, jnp.int32),
                          jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32))
    t_rb = trb.RingBuffer(torch.as_tensor(data0),
                          torch.zeros(B, dtype=torch.int32),
                          torch.zeros(B, dtype=torch.int32),
                          torch.zeros(B, dtype=torch.int32))
    seen = {"clamped": False, "full": False, "wrapped": False,
            "at_cap": False, "stuffed": False}
    kinds = ["write160"] * 4 + ["write80", "read", "read", "move"]
    for step in range(240):
        kind = kinds[rng.integers(len(kinds))]
        free = trb.available_write(t_rb)
        if kind.startswith("write"):
            n = 160 if kind == "write160" else 80
            vals = rng.integers(-60000, 60000, (B, n)).astype(np.int32)
            seen["clamped"] |= bool((free < n).any())
            seen["full"] |= bool((free == 0).any())
            j_rb = jax_ops[kind](j_rb, jnp.asarray(vals))
            t_rb = trb.write(t_rb, torch.as_tensor(vals))
        elif kind == "read":
            j_vals, j_rb = jax_ops["read"](j_rb)
            t_vals, t_rb = trb.read(t_rb, 80)
            np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals),
                                          err_msg=f"step {step}: read")
        else:
            count = rng.integers(-900, 900, B).astype(np.int32)
            seen["stuffed"] |= bool((count < 0).any())
            j_rb = jax_ops["move"](j_rb, jnp.asarray(count))
            t_rb = trb.move_read_ptr(t_rb, torch.as_tensor(count))
        _assert_same(t_rb, j_rb, f"step {step} ({kind})")
        seen["wrapped"] |= bool((t_rb.rw_wrap == trb.DIFF_WRAP).any())
        seen["at_cap"] |= bool(((t_rb.write_pos == CAP)
                                | (t_rb.read_pos == CAP)).any())
    assert all(seen.values()), seen


def test_init_empties_the_rings():
    rb = trb.RingBuffer(torch.ones((B, CAP), dtype=torch.int16),
                        torch.full((B,), 7, dtype=torch.int32),
                        torch.full((B,), 9, dtype=torch.int32),
                        torch.ones(B, dtype=torch.int32))
    empty = trb.init(rb)
    assert not empty.data.any() and empty.data.shape == (B, CAP)
    assert int(trb.available_read(empty).abs().sum()) == 0


def _case(seed=3):
    rng = np.random.default_rng(seed)
    t = torch.as_tensor
    data = t(rng.integers(-32768, 32768, (B, CAP)).astype(np.int16))
    pos = t(rng.integers(0, CAP + 1, B).astype(np.int32))
    pos[0] = CAP
    values = t(rng.integers(-60000, 60000, (B, 160)).astype(np.int32))
    n_write = t(rng.integers(0, 161, B).astype(np.int32))
    n_write[1] = 0
    return data, pos, values, n_write


def test_wrappers_take_the_plain_version_on_cpu():
    """CPU tensors: the plain versions, the input ring left as it was,
    no launch counted."""
    data, pos, values, n_write = _case()
    before = data.clone()
    launches = (ring_kernels.ring_gather.launches,
                ring_kernels.ring_write.launches)
    got = ring_kernels.ring_write(data, pos, values, n_write)
    assert torch.equal(got, trb._contig_write(before, pos, values, n_write))
    assert torch.equal(data, before)
    for n in (80, 160):
        assert torch.equal(ring_kernels.ring_gather(data, pos, n),
                           trb._contig_read(data, pos, n))
    assert (ring_kernels.ring_gather.launches,
            ring_kernels.ring_write.launches) == launches


def test_plain_write_semantics():
    """values[:n_write] land at pos mod C, wrapped to int16; the rest of the
    ring is untouched."""
    data, pos, values, n_write = _case(4)
    got = trb._contig_write(data, pos, values, n_write).numpy()
    want = data.numpy().copy()
    for b in range(B):
        for j in range(int(n_write[b])):
            want[b, (int(pos[b]) + j) % CAP] = np.array(
                int(values[b, j])).astype(np.int16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["ring_gather", "ring_write"])
def test_other_devices_raise(fn):
    """Only CPU (plain version) and CUDA (kernel) tensors are served."""
    z = torch.zeros((2, CAP), dtype=torch.int16, device="meta")
    p = torch.zeros((2,), dtype=torch.int32, device="meta")
    v = torch.zeros((2, 80), dtype=torch.int32, device="meta")
    args = (z, p, 80) if fn == "ring_gather" else (z, p, v, p)
    with pytest.raises(RuntimeError, match=f"no {fn} kernel"):
        getattr(ring_kernels, fn)(*args)


def test_wrappers_check_shapes():
    data, pos, values, n_write = _case()
    with pytest.raises(ValueError):
        ring_kernels.ring_gather(data.to(torch.int32), pos, 80)
    with pytest.raises(ValueError):
        ring_kernels.ring_write(data, pos[:2], values, n_write)
