"""K3, the tracker's crop kernel (``ops/cuda/crop.py``), on the CPU: its
plain twin against the JAX package's crop and normalize, the C signature its
wrapper passes, and the tracker's crop routes.

Tolerances: float32 crops within test_crop_matches_jax's atol 1e-3 of JAX's
(the same formula; pixels 0-255 normalized by std·255 ≈ 57, so the gap is far
smaller); a bfloat16 crop is the float32 crop rounded once (exact), and so
within half a bfloat16 ulp (2^-8 of the value) plus that 1e-3 of JAX's."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feartracker_tpu.ops import crop as jcrop
from feartracker_tpu_torch.models.fbnet import TINY_TRUNK
from feartracker_tpu_torch.models.fear_net import FEARNet
from feartracker_tpu_torch.ops import crop as tcrop
from feartracker_tpu_torch.ops.cuda import build as kbuild
from feartracker_tpu_torch.ops.cuda import crop as k3
from feartracker_tpu_torch.tracker.config import TrackerConfig
from feartracker_tpu_torch.tracker.runtime import ScanTracker

H, W = 90, 120
# one stream per edge case: inside, past the left, top, right and bottom
# edges, wholly outside, and larger than the frame on every side
WINDOWS = np.array([
    [20.0, 10.0, 60.0, 50.0],
    [-30.0, 20.0, 60.0, 40.0],
    [30.0, -25.0, 50.0, 60.0],
    [90.0, 20.0, 60.0, 40.0],
    [20.0, 60.0, 50.0, 60.0],
    [200.0, 200.0, 40.0, 40.0],
    [-40.0, -30.0, 200.0, 160.0],
], np.float32)
S = len(WINDOWS)
PAD = np.random.RandomState(5).uniform(0, 255, (S, 3)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(kind: str) -> torch.Tensor:
    rng = np.random.RandomState(0)
    if kind == "float32":
        return torch.from_numpy(rng.uniform(0, 255, (S, H, W, 3)).astype(np.float32))
    frames = torch.from_numpy(rng.randint(0, 256, (S, H, W, 3)).astype(np.uint8))
    # "shared": one frame expanded over the streams, stream stride 0
    return frames[0].expand(S, H, W, 3) if kind == "shared" else frames


def _jax_crop(frames: torch.Tensor, out: int) -> np.ndarray:
    fn = jax.vmap(lambda f, w, p: jcrop.normalize_imagenet(jcrop.crop_resize(f, w, out, p)))
    return np.asarray(fn(jnp.asarray(frames.float().numpy()), jnp.asarray(WINDOWS), jnp.asarray(PAD)))


@pytest.mark.parametrize("out", [128, 256])
@pytest.mark.parametrize("kind", ["uint8", "float32", "shared"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_twin_matches_jax_crop(kind, out, dtype):
    frames = _frames(kind)
    windows, pad = torch.from_numpy(WINDOWS), torch.from_numpy(PAD)
    got = k3.crop_cuda(frames, windows, out, pad, dtype)
    assert got.dtype == dtype and tuple(got.shape) == (S, out, out, 3) and got.is_contiguous()
    ref = _jax_crop(frames, out)
    f32 = k3.crop_plain(frames, windows, out, pad, torch.float32)
    np.testing.assert_allclose(f32.numpy(), ref, atol=1e-3)
    # one rounding of the float32 crop, nowhere else
    assert torch.equal(got, f32.to(dtype))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -8, atol=1e-3)
    # gathering uint8 taps and widening them equals widening the frame first
    assert torch.equal(f32, tcrop.normalize_imagenet(tcrop.crop_resize(frames.float(), windows, out, pad)))
    # the stream wholly outside the frame reads its pad colour alone
    pad_only = tcrop.normalize_imagenet(pad[5]).expand(out * out, 3)
    np.testing.assert_allclose(f32[5].reshape(-1, 3).numpy(), pad_only.numpy(), atol=1e-5)


class _FakeLibrary:
    """Stands in for the built library: takes ``fear_crop``'s arguments
    through their ctypes types, as a call would, and records them."""

    def __init__(self):
        self.calls = []

    def fear_crop(self, *args):
        types = kbuild.SIGNATURES["fear_crop"]
        assert len(args) == len(types)
        self.calls.append([t(a).value for t, a in zip(types, args)])
        return 0


@pytest.mark.parametrize("kind, dtype", [("shared", torch.bfloat16), ("float32", torch.float32)],
                         ids=["shared_u8_bf16", "strided_f32"])
def test_wrapper_passes_the_c_signature(monkeypatch, kind, dtype):
    """What the CPU can check of a launch: the argument list matches the C
    signature, the frame's strides go as they are (0 on the stream axis of a
    shared frame), and the result is the buffer the kernel is told to write."""
    fake = _FakeLibrary()
    monkeypatch.setattr(k3, "load_library", lambda: fake)
    monkeypatch.setattr(k3.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(k3.torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 7})())
    frames = _frames(kind)
    if kind == "float32":
        frames = frames.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)  # W-major storage
    windows, pad = torch.from_numpy(WINDOWS), torch.from_numpy(PAD)
    before = k3.crop_cuda.launches
    got = k3._launch(frames, windows, 128, pad, dtype)
    (a,) = fake.calls
    assert a[0] == frames.data_ptr() and a[1] == int(kind != "float32")
    assert a[2:6] == list(frames.stride()) and (a[2] == 0) == (kind == "shared")
    assert a[6] == windows.data_ptr() and a[7] == pad.data_ptr() and a[8] == got.data_ptr()
    assert a[9] == int(dtype == torch.bfloat16) and a[10:14] == [S, H, W, 128] and a[20] == 7 and len(a) == 21
    # the float32 constants normalize_imagenet subtracts and divides by
    assert a[14:20] == torch.cat(tcrop._imagenet_stats(torch.device("cpu"))).tolist()
    assert got.dtype == dtype and tuple(got.shape) == (S, 128, 128, 3) and got.is_contiguous()
    assert k3.crop_cuda.launches == before + 1


def test_kernel_inputs_are_checked():
    frames = _frames("uint8")
    with pytest.raises(ValueError, match="unsupported device"):
        k3._check(frames, torch.from_numpy(WINDOWS), torch.from_numpy(PAD), torch.bfloat16)


def test_unknown_crop_route_raises():
    model = FEARNet(TINY_TRUNK, adjust_channels=16, towernum=1, template_size=32)
    with pytest.raises(ValueError, match="crop_impl"):
        ScanTracker(model, TrackerConfig(), device="cpu", crop_impl="bogus")
    assert ScanTracker(model, TrackerConfig(template_size=32, instance_size=64, score_size=8, total_stride=8),
                       device="cpu").crop_impl == "kernel"
