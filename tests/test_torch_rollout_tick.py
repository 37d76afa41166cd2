"""The port's fused rollout tick (``repro_torch.kernels.rollout_tick``)
against ``repro.kernels.rollout_tick``: the plain version against the
Pallas kernel in interpret mode and its jnp reference, on the same
numpy-made inputs, plus the wrapper's routing and input checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rollout_tick import fused_tick as jax_fused_tick
from repro.kernels.rollout_tick import fused_tick_reference
from repro_torch.kernels import rollout_tick as K
from test_torch_noise import assert_hist_close

SLOTS, K_SAMPLES = 14, 16
TOL = dict(rtol=1e-6, atol=0)


def _inputs(rows: int, seed: int) -> dict:
    """Packed inputs as ``_tick_pallas`` builds them, drawn with numpy:
    pressures across the knee, heterogeneous delay curves, some nodes
    oversubscribed, ~60% of slots active, uniforms in [tiny, 1)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    nodev = np.stack([
        rng.uniform(0.05, 1.3, rows),          # rho_p
        rng.uniform(2.0, 60.0, rows),          # threads_total
        rng.choice([16.0, 32.0, 96.0], rows),  # cores
        rng.uniform(2.0, 4.0, rows),           # delay_base
        rng.uniform(40.0, 70.0, rows),         # delay_scale
        rng.choice([0.03, 0.05, 0.08], rows),  # rho_knee
        rng.uniform(0.1, 0.2, rows),           # oversub_slope
        rng.standard_normal(rows),             # delay noise
    ], axis=-1).astype(f32)
    tiny = np.finfo(f32).tiny
    u = rng.uniform(0.0, 1.0, (2, rows, SLOTS * K_SAMPLES)).astype(f32)
    return dict(
        nodev=nodev,
        jit_all=(1.0 + 0.18 * rng.standard_normal((rows, SLOTS))).astype(f32),
        act_all=(rng.uniform(size=(rows, SLOTS)) < 0.6).astype(f32),
        u1=np.maximum(u[0], tiny), u2=np.maximum(u[1], tiny))


def _port(inp: dict):
    return K.fused_tick(*(torch.as_tensor(inp[k]) for k in
                          ("nodev", "jit_all", "act_all", "u1", "u2")))


def _jax_args(inp: dict):
    return [jnp.asarray(inp[k]) for k in
            ("nodev", "jit_all", "act_all", "u1", "u2")]


@pytest.mark.parametrize("rows,block", [(5, 4), (40, 8)])
def test_plain_matches_pallas_kernel_and_reference(rows, block):
    """R = 5 on block 4 takes the JAX kernel's padding path.  Histogram
    totals are exact; a sample may change bin only where XLA's and torch's
    log differ in the last ulp at a 5-unit edge; delay and mean 1e-6."""
    inp = _inputs(rows, seed=rows)
    hist, delay, mean = _port(inp)
    assert hist.shape == (rows, 200) and delay.shape == (rows,)
    assert mean.shape == (rows, SLOTS)
    np.testing.assert_array_equal(hist.sum(-1).numpy(),
                                  inp["act_all"].sum(-1) * K_SAMPLES)
    for want in (jax_fused_tick(*_jax_args(inp), block=block, interpret=True),
                 fused_tick_reference(*_jax_args(inp))):
        assert_hist_close(hist, want[0])
        np.testing.assert_allclose(delay.numpy(), np.asarray(want[1]), **TOL)
        np.testing.assert_allclose(mean.numpy(), np.asarray(want[2]), **TOL)


def test_pressure_past_the_knee_clips_the_delay():
    inp = _inputs(6, seed=1)
    inp["nodev"][:, 0] = 0.999                 # rho at the knee
    inp["nodev"][:, 7] = 3.0                   # +3 sigma jitter
    _, delay, _ = _port(inp)
    assert float(delay.max()) == pytest.approx(K.CLIP_MAX)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    inp = _inputs(7, seed=2)
    calls = []

    def plain(*a, **kw):
        calls.append(a[0].shape)
        return K_plain(*a, **kw)

    K_plain = K.fused_tick_plain
    monkeypatch.setattr(K, "fused_tick_plain", plain)
    before = K.launches
    _port(inp)
    assert calls == [(7, 8)]
    assert K.launches == before


@pytest.mark.parametrize("bad", [
    "nodev_width", "act_shape", "u_ragged", "u_mismatch", "dtype",
    "not_contiguous", "one_dim",
])
def test_bad_inputs_raise(bad):
    t = {k: torch.as_tensor(v) for k, v in _inputs(4, seed=3).items()}
    if bad == "nodev_width":
        t["nodev"] = t["nodev"][:, :7].contiguous()
    elif bad == "act_shape":
        t["act_all"] = t["act_all"][:3]
    elif bad == "u_ragged":
        t["u1"] = t["u1"][:, :-1].contiguous()
        t["u2"] = t["u2"][:, :-1].contiguous()
    elif bad == "u_mismatch":
        t["u2"] = t["u2"][:, :SLOTS * 8].contiguous()
    elif bad == "dtype":
        t["jit_all"] = t["jit_all"].double()
    elif bad == "not_contiguous":
        t["u1"] = t["u1"].t().contiguous().t()
    elif bad == "one_dim":
        t["nodev"] = t["nodev"].reshape(-1)
    with pytest.raises(ValueError):
        K.fused_tick(t["nodev"], t["jit_all"], t["act_all"], t["u1"], t["u2"])


def _unpacked(rows: int, seed: int) -> tuple:
    """The tick's own tensors as ``_tick_fused`` hands them over: fields
    (R,), a normals column and noise-bundle views with the bulk draws' row
    strides, bool masks."""
    from repro_torch.cluster import state as tstate

    inp = _inputs(rows, seed)
    gen = torch.Generator().manual_seed(seed)
    noise = tstate.draw_noise(gen, rows, 1)[0]
    nodev = torch.as_tensor(inp["nodev"])
    fields = [nodev[:, f].contiguous() for f in range(7)] + [noise.delay]
    rng = np.random.default_rng(seed)
    on = torch.as_tensor(rng.uniform(size=(rows, tstate.S_ON)) < 0.6)
    off = torch.as_tensor(rng.uniform(size=(rows, tstate.S_OFF)) < 0.4)
    return (fields, noise.jit_on, noise.jit_off, on, off, noise.u_on,
            noise.u_off)


@pytest.mark.parametrize("rows,seed", [(5, 0), (37, 1), (64, 2)])
def test_unpacked_plain_equals_packed_plain_bit_for_bit(rows, seed):
    """The main path's entry, on the tick's tensors where they lie, against
    ``fused_tick_plain`` on the packed arguments JAX's kernel takes."""
    args = _unpacked(rows, seed)
    assert args[0][7].stride(0) > 1 and not args[5].is_contiguous()
    got = K.fused_tick_unpacked(*args)
    packed = K.pack(*args)
    want = K.fused_tick_plain(*packed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0].sum(-1), packed[2].sum(-1) * 16)


def _read_through(args) -> dict:
    """The packed inputs rebuilt by reading memory at the addresses the
    kernel computes from ``args`` (``csrc/rollout_tick.cu``)."""
    import ctypes

    def f32(addr):
        return ctypes.c_float.from_address(addr).value

    rows, k = args.rows, args.k
    nodev = [[f32(args.field[f] + 4 * r * args.field_stride[f])
              for f in range(8)] for r in range(rows)]
    jit, act, u1, u2 = [], [], [], []
    for r in range(rows):
        jr, ar, p1, p2 = [], [], [], []
        for kind in args.kind:
            for s in range(kind.slots):
                x = f32(kind.jit + 4 * (r * kind.jit_stride + s))
                jr.append(np.float32(1) + np.float32(0.18) * np.float32(x)
                          if args.jit_raw else x)
                if args.act_bool:
                    ar.append(float(ctypes.c_uint8.from_address(
                        kind.act + r * kind.act_stride + s).value))
                else:
                    ar.append(f32(kind.act + 4 * (r * kind.act_stride + s)))
                for i in range(k):
                    off = 4 * (r * kind.u_stride + (s * k + i) * args.u_step)
                    p1.append(f32(kind.u1 + off))
                    p2.append(f32(kind.u2 + off))
        jit.append(jr), act.append(ar), u1.append(p1), u2.append(p2)
    return {name: np.asarray(v, np.float32) for name, v in (
        ("nodev", nodev), ("jit_all", jit), ("act_all", act), ("u1", u1),
        ("u2", u2))}


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_kernel_arguments_describe_the_tensors(layout):
    """The pointers and strides handed to the kernel address exactly the
    packed inputs, read through memory as the kernel reads them."""
    args = _unpacked(6, 3)
    packed = K.pack(*args)
    outs = K._outputs(6, packed[1].shape[1], "cpu")
    if layout == "unpacked":
        targs = K._unpacked_args(*args, outs, 2.0, K.CLIP_MAX)
        assert (targs.u_step, targs.jit_raw, targs.act_bool) == (2, 1, 1)
    else:
        targs = K._packed_args(*packed, outs, 2.0, K.CLIP_MAX)
        assert (targs.u_step, targs.jit_raw, targs.act_bool) == (1, 0, 0)
    assert targs.rows == 6 and targs.k == K_SAMPLES
    K._check_vector_loads(targs)
    got = _read_through(targs)
    for name, want in zip(("nodev", "jit_all", "act_all", "u1", "u2"),
                          packed):
        np.testing.assert_array_equal(got[name], want.numpy(), err_msg=name)


def _struct_values(obj):
    """A ctypes struct's fields as nested Python values, for comparison."""
    import ctypes

    if isinstance(obj, ctypes.Structure):
        return {name: _struct_values(getattr(obj, name))
                for name, _ in obj._fields_}
    if isinstance(obj, ctypes.Array):
        return [_struct_values(x) for x in obj]
    return obj


def test_cached_arguments_repointed_equal_fresh_ones():
    """A tick of a layout seen before reuses its struct and rewrites only
    the pointers: the result equals the struct built afresh."""
    first, second = _unpacked(6, 3), _unpacked(6, 4)
    outs = [K._outputs(6, 14, "cpu") for _ in range(2)]
    cached = K._unpacked_args(*first, outs[0], 2.0, K.CLIP_MAX)
    fresh = K._unpacked_args(*second, outs[1], 2.0, K.CLIP_MAX)
    assert _struct_values(cached) != _struct_values(fresh)
    fields, jon, joff, on, off, uon, uoff = second
    K._set_pointers(cached, fields, ((jon, on, uon), (joff, off, uoff)),
                    outs[1])
    assert _struct_values(cached) == _struct_values(fresh)


@pytest.mark.parametrize("bad", ["k", "offset", "u_stride", "u2_offset"])
def test_vector_loads_refuse_unaligned_uniforms(bad):
    """The kernel loads uniforms as 16-byte vectors; what breaks that raises
    before a launch instead of taking another code path."""
    args = _unpacked(6, 3)
    packed = list(K.pack(*args))
    outs = K._outputs(6, packed[1].shape[1], "cpu")
    n = packed[3].shape[1]
    if bad == "k":              # 6 samples a slot
        packed[3:] = [x.view(6, 14, 16)[:, :, :6].reshape(6, -1)
                      for x in packed[3:]]
    elif bad == "offset":       # u1 one float into its storage
        packed[3] = torch.empty(6 * n + 1)[1:].view(6, n).copy_(packed[3])
    elif bad == "u2_offset":    # u2 two floats into its storage
        packed[4] = torch.empty(6 * n + 2)[2:].view(6, n).copy_(packed[4])
    if bad == "u_stride":       # the state's layout, rows of 2 S K + 1 floats
        fields, jon, joff, on, off, uon, uoff = args
        width = uon[0].numel() + 1
        wide = torch.zeros(6 * width).as_strided(uon.shape,
                                                 (width, *uon.stride()[1:]))
        targs = K._unpacked_args(fields, jon, joff, on, off,
                                 wide.copy_(uon), uoff, outs, 2.0, K.CLIP_MAX)
    else:
        targs = K._packed_args(*packed, outs, 2.0, K.CLIP_MAX)
    with pytest.raises(ValueError):
        K._check_vector_loads(targs)


@pytest.mark.parametrize("bad", ["fields", "mask_dtype", "u_shape",
                                 "u_layout", "devices"])
def test_unpacked_bad_inputs_raise(bad):
    fields, jon, joff, on, off, uon, uoff = _unpacked(4, 5)
    if bad == "fields":
        fields = fields[:7]
    elif bad == "mask_dtype":
        on = on.float()
    elif bad == "u_shape":
        uoff = uoff[:, :, :8]
    elif bad == "u_layout":
        uon = uon.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "devices":
        fields[3] = fields[3].to("meta")
    with pytest.raises(ValueError):
        K.fused_tick_unpacked(fields, jon, joff, on, off, uon, uoff)
