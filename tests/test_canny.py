"""Canny at full width: ops.canny against cv2.Canny on 640x480 renders, its
vmap against per-image calls, and the hysteresis fixpoint against a
connected-component reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from revo_tpu import ops

cv2 = pytest.importorskip("cv2")
ndimage = pytest.importorskip("scipy.ndimage")

_canny = jax.jit(ops.canny, static_argnums=(1, 2))


def _render_gray(seed: int) -> np.ndarray:
    from revo_tpu.config import CameraConfig
    from revo_tpu.io.synthetic import SyntheticScene, render_frame

    scene = SyntheticScene()
    T = scene.trajectory(seed + 2, seed=seed)[-1]
    gray, _ = render_frame(scene, CameraConfig(), T, seed=seed)
    return np.clip(np.round(gray), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thresholds", [(150, 100), (60, 20)])
def test_matches_opencv_640x480(seed, thresholds):
    img = _render_gray(seed)
    assert img.shape == (480, 640)
    want = cv2.Canny(img, *thresholds, apertureSize=3, L2gradient=True) > 0
    got = np.asarray(
        _canny(jnp.asarray(img, jnp.float32), *map(float, thresholds))
    )
    assert want.sum() > 5000  # a real edge map, not an empty one
    assert (got == want).all()


def test_vmap_matches_per_image():
    imgs = np.stack([_render_gray(s)[::2, ::2] for s in range(3)])
    batched = np.asarray(
        jax.jit(jax.vmap(lambda g: ops.canny(g, 150.0, 100.0)))(
            jnp.asarray(imgs, jnp.float32)
        )
    )
    for b in range(len(imgs)):
        single = np.asarray(
            _canny(jnp.asarray(imgs[b], jnp.float32), 150.0, 100.0)
        )
        assert (batched[b] == single).all()


@pytest.mark.parametrize("with_seeds", [True, False])
def test_hysteresis_matches_component_reference(with_seeds):
    rng = np.random.default_rng(3)
    cand = rng.random((96, 128)) < 0.45  # percolating weak-edge clusters
    strong = cand & (rng.random(cand.shape) < (0.01 if with_seeds else 0.0))
    got = np.asarray(
        jax.jit(ops.hysteresis)(jnp.asarray(cand), jnp.asarray(strong))
    )
    # Reference: every 8-connected candidate component holding a seed.
    labels, _ = ndimage.label(cand, structure=np.ones((3, 3), bool))
    seeded = np.unique(labels[strong])
    want = np.isin(labels, seeded[seeded > 0])
    assert got.sum() == want.sum()
    assert (got == want).all()
    assert got.any() == with_seeds


def _serpentine(h: int, w: int):
    """One 8-connected candidate path snaking through every other row and
    linked at alternating ends (about h*w/2 pixels long, far beyond h + w
    dilations), seeded at its start."""
    cand = np.zeros((h, w), bool)
    cand[::2] = True
    for r in range(1, h, 2):
        cand[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    strong = np.zeros_like(cand)
    strong[0, 0] = True
    return cand, strong


@pytest.mark.parametrize("impl", ["xla", "triton_interpret"])
def test_hysteresis_serpentine_runs_to_fixpoint(impl):
    from revo_tpu.ops.hysteresis_triton import hysteresis_triton

    cand, strong = _serpentine(40, 48)
    fn = {
        "xla": ops.hysteresis,
        "triton_interpret": lambda c, s: hysteresis_triton(
            c, s, interpret=True
        ),
    }[impl]
    got = np.asarray(jax.jit(fn)(jnp.asarray(cand), jnp.asarray(strong)))
    labels, _ = ndimage.label(cand, structure=np.ones((3, 3), bool))
    want = labels == labels[0, 0]
    assert want.sum() > 10 * (40 + 48)  # the whole path, end to end
    assert (got == want).all()


@pytest.mark.parametrize("with_seeds", [True, False])
def test_triton_hysteresis_interpret_matches_xla(with_seeds):
    from revo_tpu.ops.hysteresis_triton import hysteresis_triton

    rng = np.random.default_rng(11)
    cand = rng.random((70, 150)) < 0.45  # not a multiple of the tile shape
    strong = cand & (rng.random(cand.shape) < (0.01 if with_seeds else 0.0))
    want = np.asarray(
        jax.jit(ops.hysteresis)(jnp.asarray(cand), jnp.asarray(strong))
    )
    got = np.asarray(jax.jit(
        lambda c, s: hysteresis_triton(c, s, interpret=True)
    )(jnp.asarray(cand), jnp.asarray(strong)))
    assert (got == want).all()
    assert got.any() == with_seeds


def test_triton_hysteresis_interpret_vmap():
    from revo_tpu.ops.hysteresis_triton import hysteresis_triton

    rng = np.random.default_rng(12)
    cand = rng.random((3, 40, 70)) < 0.45
    strong = cand & (rng.random(cand.shape) < 0.02)
    want = np.asarray(jax.jit(jax.vmap(ops.hysteresis))(cand, strong))
    got = np.asarray(jax.jit(jax.vmap(
        lambda c, s: hysteresis_triton(c, s, interpret=True)
    ))(cand, strong))
    assert (got == want).all()


def test_canny_picks_triton_kernel_only_for_cuda():
    from jax import export

    f = jax.jit(lambda g: ops.canny(g, 150.0, 100.0))
    x = jax.ShapeDtypeStruct((120, 160), jnp.float32)
    cuda = export.export(
        f, platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(x).mlir_module()
    cpu = export.export(f, platforms=["cpu"])(x).mlir_module()
    assert "canny_hysteresis_tile" in cuda
    assert "xla.gpu.triton" not in cpu
