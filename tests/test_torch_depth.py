"""The depth front end of the port against the JAX package's, on the CPU:
the depth-model adapters, the tiny monodepth net with its torch Gaussian
blur (OpenCV's rules), its weights, and the parameter converter."""

import filecmp
import os

import numpy as np
import pytest
import torch

from xmtpu.pipeline import depth as jdepth
from xmtpu.pipeline import depth_net as jnet
from xmtpu_torch.convert import depth_net_state_from_reference
from xmtpu_torch.pipeline import depth as tdepth
from xmtpu_torch.pipeline import depth_net as tnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _views(n=3, size=96, seed=5):
    """Seeded gray views with a plane-like depth ramp."""
    rng = np.random.default_rng(seed)
    images = [(rng.random((size, size, 3)) * 255).astype(np.uint8)
              for _ in range(n)]
    depths = [2.0 + np.add.outer(np.arange(size), np.arange(size)) / size
              + k for k in range(n)]
    depths[0][:5] = 0.0
    return images, depths


def test_noisy_depth_model_draws_match():
    images, depths = _views()
    a = jdepth.NoisyDepthModel(images, depths, rel_sigma=0.03, seed=4)
    b = tdepth.NoisyDepthModel(images, depths, rel_sigma=0.03, seed=4)
    for im in images + images[::-1]:
        for x, y in zip(a.infer(im), b.infer(im)):
            np.testing.assert_array_equal(x, y)


def test_callable_adapter_and_frame_binding():
    images, depths = _views()
    calls = []

    def fn(rgb):
        calls.append(1)
        return rgb[..., 0] / 10.0, np.ones(rgb.shape[:2])

    for mod in (jdepth, tdepth):
        calls.clear()
        model = mod.as_depth_model(fn)
        assert isinstance(model, mod.CallableDepthModel)
        for_frame = mod.depth_for_frames(model, images)
        d1, c1 = for_frame(1)
        assert for_frame(1)[0] is d1 and len(calls) == 1    # memoized
        assert d1.dtype == np.float64 and c1.dtype == np.float64
        np.testing.assert_array_equal(d1, images[1][..., 0] / 10.0)
        assert mod.as_depth_model(model) is model
        with pytest.raises(TypeError, match="not a depth model"):
            mod.as_depth_model(3)
        with pytest.raises(NotImplementedError):
            mod.DepthModel().infer(images[0])


def test_unidepth_model_refuses_without_its_package():
    """The ``unidepth`` package is external and absent: a helpful
    ImportError, nothing fetched."""
    with pytest.raises(ImportError, match="unidepth"):
        tdepth.UniDepthModel(device="cpu")


@pytest.mark.parametrize("size", [192, 400])
def test_blur_matches_opencv(size):
    """``gaussian_blur`` at sigma = 50 (a 401-tap kernel, wider than the
    image, reflected again and again) against ``cv2.GaussianBlur`` on f32
    images, within 1e-5 of the blurred map's largest magnitude (measured
    1.3e-6 to 1.4e-6)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(size)
    for img in (rng.normal(size=(size, size)),
                np.cumsum(rng.normal(size=(size, size)), axis=1) + 3.0):
        img = img.astype(np.float32)
        want = cv2.GaussianBlur(img, (0, 0), 50.0)
        got = tnet.gaussian_blur(torch.from_numpy(img), 50.0).numpy()
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_blur_matrix_rules():
    """The kernel size ``round(8 sigma + 1) | 1``, rows that sum to one, a
    narrow kernel equal to ``getGaussianKernel`` inside the image, and the
    border rule equal to ``cv2.borderInterpolate``'s, reflected again and
    again."""
    cv2 = pytest.importorskip("cv2")
    B = tnet.blur_matrix(50, 1.5)
    k = cv2.getGaussianKernel(int(round(1.5 * 8 + 1)) | 1, 1.5,
                              cv2.CV_32F).ravel()
    r = len(k) // 2
    np.testing.assert_allclose(B[25, 25 - r:25 + r + 1], k, rtol=1e-6)
    np.testing.assert_allclose(B.sum(axis=1), 1.0, atol=1e-6)
    for n in (1, 2, 3, 7):
        p = np.arange(-3 * n - 2, 4 * n + 3)
        np.testing.assert_array_equal(
            tnet._reflect_101(p, n),
            [cv2.borderInterpolate(int(q), n, cv2.BORDER_REFLECT_101)
             for q in p])
    assert tnet.blur_matrix(1, 50.0).tolist() == [[1.0]]


def test_tiny_monodepth_matches_jax_package():
    """Depth and confidence of the port's net on the CPU against the JAX
    package's (torch on the CPU with cv2's blur), within 1e-5 of each map's
    largest value (measured 2.0e-6)."""
    pytest.importorskip("cv2")
    from xmtpu_torch.pipeline.synthetic_images import render_plane_views

    images = render_plane_views(n_views=3, size=192)[0]
    a, b = jnet.TinyMonoDepthModel(), tnet.TinyMonoDepthModel(device="cpu")
    for im in images:
        for x, y in zip(a.infer(im), b.infer(im)):
            assert y.dtype == np.float64 and y.shape == x.shape
            assert np.abs(x - y).max() <= 1e-5 * np.abs(x).max()
    # no blur: the nets alone
    a = jnet.TinyMonoDepthModel(smooth_sigma=0.0)
    b = tnet.TinyMonoDepthModel(smooth_sigma=0.0, device="cpu")
    for x, y in zip(a.infer(images[0]), b.infer(images[0])):
        assert np.abs(x - y).max() <= 1e-5 * np.abs(x).max()


def test_weights_are_the_jax_package_asset():
    assert filecmp.cmp(os.path.join(ROOT, "xmtpu", "assets",
                                    "tiny_monodepth.pt"),
                       tnet.WEIGHTS_PATH, shallow=False)
    assert tnet.WEIGHTS_PATH.startswith(os.path.join(ROOT, "xmtpu_torch"))


def test_convert_depth_net_parameters():
    """The JAX package's parameters as numpy arrays by its module's names
    -> the port's state_dict: the same net, the same output."""
    ref = jnet.build_net()
    ref.load_state_dict(torch.load(jnet.WEIGHTS_PATH, map_location="cpu",
                                   weights_only=True))
    params = {k: v.numpy() for k, v in ref.state_dict().items()}
    state = depth_net_state_from_reference(params)
    net = tnet.build_net()
    net.load_state_dict(state)
    x = torch.from_numpy(tnet._to_input(
        np.random.default_rng(0).integers(0, 255, (64, 80, 3))))
    with torch.no_grad():
        torch.testing.assert_close(net(x), ref(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="missing"):
        depth_net_state_from_reference(
            {k: v for k, v in params.items() if k != "body.0.bias"})
    with pytest.raises(ValueError, match="unknown"):
        depth_net_state_from_reference({**params, "head.weight": params[
            "body.0.bias"]})
    with pytest.raises(ValueError, match="shape"):
        depth_net_state_from_reference({**params, "body.0.bias": params[
            "body.0.bias"][:3]})
