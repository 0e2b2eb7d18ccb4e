"""The PyTorch port's batched ring buffer == the JAX package's (tolerance 0).

webrtc_aecm_tpu_torch/ops/ring_buffer.py `write`, `read` and
`move_read_ptr` on a batch of int16 jitter rings against `jax.vmap` of
webrtc_aecm_tpu/ops/ring_buffer.py's per-ring functions (whose data passes
take their plain reference off the TPU), over seeded random sequences
that fill the rings until writes clamp (down to zero samples), wrap, stuff
the read pointer backwards, and bring pointers to rest exactly at the
capacity.  `write_plain` and `read_frames_plain`, the plain versions of
the ring_write / ring_read kernels (pointer arithmetic and data pass in
one function; the read serves every frame of a Process call), are held
to the same JAX functions on planted edge cases.  On CPU tensors the
wrappers take those plain versions and count no kernel launch; they
convert nothing and raise on what the kernels would not take.
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


def _rings(seed, n_values=160):
    """Consistent ring states with the edge cases planted: ring 0 full,
    ring 1 with fewer than 80 readable, ring 2 with its read position
    resting at the capacity, ring 3 with exactly n_values to its end, ring
    4 empty, ring 5 random; values outside the int16 range."""
    rng = np.random.default_rng(seed)
    data = rng.integers(-32768, 32768, (B, CAP)).astype(np.int16)
    rp = np.array([500, 3990, CAP, CAP - n_values, 77,
                   rng.integers(0, CAP)], np.int32)
    wp = np.array([500, 29, 130, CAP - n_values, 77,
                   rng.integers(0, CAP)], np.int32)
    wrap = np.array([1, 1, 1, 0, 0, 0], np.int32)
    wrap[5] = int(wp[5] < rp[5])
    values = rng.integers(-60000, 60000, (B, n_values)).astype(np.int32)
    return data, rp, wp, wrap, values


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _case(seed=3):
    return _t(*_rings(seed))


@pytest.mark.parametrize("n", [80, 160])
def test_write_plain_matches_jax(jax_ops, n):
    """write_plain (clamp, store, new pointers) == jax.vmap(write): a full
    ring writes nothing and keeps its pointers, a write of exactly the
    margin rests write_pos at the capacity without flipping rw_wrap."""
    data, rp, wp, wrap, values = _rings(5, n)
    j_rb = jax_ops[f"write{n}"](
        jrb.RingBuffer(*(jnp.asarray(a) for a in (data, rp, wp, wrap))),
        jnp.asarray(values))
    got = trb.write_plain(*_t(data, rp, wp, wrap, values))
    _assert_same(trb.RingBuffer(got[0], torch.as_tensor(rp), *got[1:]),
                 j_rb, f"write of {n}")
    assert torch.equal(got[0][0], torch.as_tensor(data[0]))      # full
    assert (int(got[1][0]), int(got[2][0])) == (500, 1)
    assert (int(got[1][3]), int(got[2][3])) == (CAP, 0)          # margin


@pytest.mark.parametrize("n_frames", [1, 2])
@pytest.mark.parametrize("gated", [False, True])
def test_read_frames_plain_matches_jax(jax_ops, n_frames, gated):
    """read_frames_plain == the reads of one Process call written with the
    JAX package's read and move_read_ptr: per frame have_data = (readable
    // 80 > 0) and gate, the frame zeroed past the readable count, the
    pointer advanced where have_data; the second frame starts where the
    first left the pointer."""
    data, rp, wp, wrap, _ = _rings(6)
    gate = np.array([True, True, False, True, True, not gated])
    if not gated:
        gate[:] = True
    j_rb = jrb.RingBuffer(*(jnp.asarray(a) for a in (data, rp, wp, wrap)))
    want_frames, want_have = [], []
    for _ in range(n_frames):
        readable = np.asarray(jax.vmap(jrb.available_read)(j_rb))
        have = (readable // 80 > 0) & gate
        frame, _ = jax_ops["read"](j_rb)
        moved = jax_ops["move"](j_rb, jnp.minimum(jnp.asarray(readable), 80))
        j_rb = j_rb._replace(
            read_pos=jnp.where(have, moved.read_pos, j_rb.read_pos),
            rw_wrap=jnp.where(have, moved.rw_wrap, j_rb.rw_wrap))
        want_frames.append(np.asarray(frame))
        want_have.append(have)
    frames, have_data, read_pos, rw_wrap = trb.read_frames_plain(
        *_t(data, rp, wp, wrap), torch.as_tensor(gate) if gated else None,
        80, n_frames)
    np.testing.assert_array_equal(frames.numpy(), np.stack(want_frames, 1))
    np.testing.assert_array_equal(have_data.numpy(), np.stack(want_have, 1))
    np.testing.assert_array_equal(read_pos.numpy(), np.asarray(j_rb.read_pos))
    np.testing.assert_array_equal(rw_wrap.numpy(), np.asarray(j_rb.rw_wrap))
    assert frames.dtype == torch.int32 and have_data.dtype == torch.bool
    assert not have_data[1].any() and not frames[1, 0, 39:].any()  # short
    assert int(frames[2, 0, 0]) == int(data[2, 0])   # read_pos == capacity


def test_read_is_the_one_frame_form(jax_ops):
    """ring_buffer.read advances by the readable count even below a whole
    frame (WebRtc_ReadBuffer), where Process's read stays put."""
    rb = trb.RingBuffer(*_t(*_rings(7)[:4]))
    j_vals, j_rb = jax_ops["read"](jrb.RingBuffer(
        *(jnp.asarray(x.numpy()) for x in rb)))
    vals, after = trb.read(rb, 80)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    _assert_same(after, j_rb, "read")
    _, _, stay = trb.read_frames(rb, 80, 1)
    assert int(after.read_pos[1]) == 29 and int(stay.read_pos[1]) == 3990


def test_wrappers_take_the_plain_version_on_cpu():
    """CPU tensors: the plain versions, the input ring and pointers left
    as they were, no launch counted."""
    data, rp, wp, wrap, values = _case()
    before = [x.clone() for x in (data, rp, wp, wrap)]
    launches = (ring_kernels.ring_read.launches,
                ring_kernels.ring_write.launches)
    got = ring_kernels.ring_write(data, rp, wp, wrap, values)
    for a, b in zip(got, trb.write_plain(*before, values)):
        assert torch.equal(a, b)
    gate = torch.tensor([True, False] * (B // 2))
    for n_frames in (1, 2):
        got = ring_kernels.ring_read(data, rp, wp, wrap, gate, 80, n_frames)
        for a, b in zip(got, trb.read_frames_plain(*before, gate, 80,
                                                   n_frames)):
            assert torch.equal(a, b)
    for x, y in zip((data, rp, wp, wrap), before):
        assert torch.equal(x, y)
    assert (ring_kernels.ring_read.launches,
            ring_kernels.ring_write.launches) == launches


def test_plain_write_semantics():
    """values[:n_write] land at write_pos mod C, wrapped to int16; the rest
    of the ring is untouched."""
    data, rp, wp, wrap, values = _case(4)
    got = trb.write_plain(data, rp, wp, wrap, values)[0].numpy()
    n_write = trb.available_write(trb.RingBuffer(data, rp, wp, wrap)
                                  ).clamp(max=160)
    assert sorted(set(n_write.tolist())) != [160]
    want = data.numpy().copy()
    for b in range(B):
        for j in range(int(n_write[b])):
            want[b, (int(wp[b]) + j) % CAP] = np.array(
                int(values[b, j])).astype(np.int16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["ring_read", "ring_write"])
def test_other_devices_raise(fn):
    """Only CPU (plain version) and CUDA (kernel) tensors are served."""
    z = torch.zeros((2, CAP), dtype=torch.int16, device="meta")
    p = torch.zeros((2,), dtype=torch.int32, device="meta")
    v = torch.zeros((2, 80), dtype=torch.int32, device="meta")
    args = (z, p, p, p, None, 80, 2) if fn == "ring_read" else (z, p, p, p, v)
    with pytest.raises(RuntimeError, match=f"no {fn} kernel"):
        getattr(ring_kernels, fn)(*args)


def test_wrappers_check_shapes():
    data, rp, wp, wrap, values = _case()
    with pytest.raises(ValueError):
        ring_kernels.ring_read(data.to(torch.int32), rp, wp, wrap, None, 80,
                               1)
    with pytest.raises(ValueError):
        ring_kernels.ring_write(data, rp[:2], wp, wrap, values)
    with pytest.raises(ValueError):
        ring_kernels.ring_write(data, rp, wp, wrap, values[:2])


@pytest.mark.parametrize("fn", ["ring_read", "ring_write"])
@pytest.mark.parametrize("bad", ["int64 positions", "non-contiguous ring",
                                 "int64 values or gate"])
def test_wrappers_convert_nothing(fn, bad):
    """An argument that is not of the kernel's type and contiguous raises;
    the wrappers convert nothing.  The write's values may be a column slice
    of a longer signal (unit inner stride)."""
    data, rp, wp, wrap, values = _case()
    extra = [values] if fn == "ring_write" else [None, 80, 2]
    getattr(ring_kernels, fn)(data, rp, wp, wrap, *extra)       # as it is
    if fn == "ring_write":
        wide = torch.cat([values, values, values], dim=1)
        got = ring_kernels.ring_write(data, rp, wp, wrap, wide[:, 160:320])
        assert torch.equal(got[0], trb.write_plain(data, rp, wp, wrap,
                                                   values)[0])
    if bad == "int64 positions":
        wp = wp.long()
    elif bad == "non-contiguous ring":
        data = torch.cat([data, data], dim=1)[:, ::2]
    elif fn == "ring_write":
        extra = [values.long()]
    else:
        extra = [torch.ones(B, dtype=torch.int64), 80, 2]
    with pytest.raises(ValueError):
        getattr(ring_kernels, fn)(data, rp, wp, wrap, *extra)
