"""Ray generation's pixel map and host-side parameters in the PyTorch port,
against the JAX package on the CPU:

- ``gen_rays_plain``'s pixel id, tile index and in-tile lane against the
  reference's ``_tile_pixel_coords`` and the index math of its ``gen_rays``
  (digital_earth_tpu/render/renderer.py:469-480, 168-172): path blocks
  (1, H), preview blocks from ``pick_block_dims``, adaptive tile lists,
  chunks that start at a nonzero lane;
- the ``gen_rays`` kernel's parameter block built from host values alone,
  field for field equal to the block read back from the camera and CIE
  tensors (the recipe of ``kernel_params`` before it stopped reading them),
  for the three scenes at 1920x1080 and 480x270; and the same block with
  the tables and the camera on the ``meta`` device, which holds no data;
- the launcher's checks on the lane range and the packet size (raised
  before anything is built or launched);
- ``trace_lanes`` on an Apollo 11 32x18 frame (path, preview, and an
  adaptive tile list) bit-equal to the same frame with the pixel map and the
  rays' origin recomputed from the lane ids, as ``trace_lanes`` did before
  ray generation returned them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_earth_tpu.render import renderer as jrend
from digital_earth_tpu_torch import kernels
from digital_earth_tpu_torch.app.config_io import apply_config, load_config
from digital_earth_tpu_torch.assets import luts as tluts
from digital_earth_tpu_torch.assets.procgen import generate_earth_textures
from digital_earth_tpu_torch.assets.textures import build_atlas
from digital_earth_tpu_torch.ops import rng
from digital_earth_tpu_torch.render import frame_end as fe
from digital_earth_tpu_torch.render import pathtracer as pt
from digital_earth_tpu_torch.render import raygen, raymarcher
from digital_earth_tpu_torch.render.camera import CameraParams, HostCamera, camera_basis
from digital_earth_tpu_torch.render.params import TraceConfig
from digital_earth_tpu_torch.render.renderer import Renderer, trace_lanes

# One intra-op thread a test process: the runner's worker processes share the
# machine's cores, and torch's OpenMP threads, each pool sized for the whole
# machine, spin against one another and against XLA's compiles.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("config - Apollo 11.txt", "config - florida.txt", "config - sunset hurricane.txt")
KEY = (0, 3)


@pytest.fixture(scope="module")
def atlas():
    return build_atlas(generate_earth_textures((64, 128), seed=3), "cpu")


@pytest.fixture(scope="module")
def luts():
    return tluts.load_spectral_luts("cpu")


def _renderer(atlas, scene, res, mode="path", cfg=TraceConfig(), tile_pixels=2048):
    r = Renderer("cpu", image_res=res, atlas=atlas, mode=mode, cfg=cfg, tile_pixels=tile_pixels)
    apply_config(r, load_config(os.path.join(ROOT, "scenes", scene)))
    return r


def _camera(seed):
    """A camera of numpy-seeded float64 values, as the Renderer holds them."""
    g = np.random.default_rng(seed)
    up = g.normal(size=3)
    return HostCamera.of(g.normal(size=3) * 2e7, g.normal(size=3), up / np.linalg.norm(up),
                         g.uniform(0.2, 0.9), g.uniform(0.8, 1.2))


# --- the pixel map ---------------------------------------------------------------

def _reference_map(res, block, tile_ids, lane0, n):
    """(tile index, in-tile lane, pid) of lanes [lane0, lane0 + n) by the
    reference: _tile_pixel_coords over the whole tile list, and its
    gen_rays's lanes (tile tile_ids[l // tile], in-tile lane l % tile)."""
    w, h = res
    tile = block[0] * block[1]
    ids = np.arange((w // block[0]) * (h // block[1]), dtype=np.int32) if tile_ids is None \
        else tile_ids
    pu, pv = jrend._tile_pixel_coords(jnp.asarray(ids), res, block)
    lane = np.arange(lane0, lane0 + n)
    pid = (np.asarray(pu) * h + np.asarray(pv))[lane]
    return ids[lane // tile].astype(np.int64), lane % tile, pid


MAP_CASES = [
    # (res, block, tile list, lane0, n): path blocks (1, H), whole and chunked
    ((48, 27), (1, 27), None, 0, 48 * 27),
    ((48, 27), (1, 27), None, 100, 500),
    ((1920, 1080), (1, 1080), None, 1_000_000, 4096),
    # preview blocks of pick_block_dims
    ((48, 27), "pick", None, 0, 48 * 27),
    ((160, 90), "pick", None, 0, 160 * 90),
    ((480, 270), "pick", None, 64_800, 3000),
    # adaptive tile lists, from lane 0 and from a nonzero lane
    ((64, 36), "pick", [11, 0, 5, 2, 7], 0, 5 * 48),
    ((480, 270), "pick", [59, 3, 17, 0, 40], 2048 + 5, 3 * 2048 - 5),
]


@pytest.mark.parametrize("res,block,tile_ids,lane0,n", MAP_CASES)
def test_plain_pixel_map_matches_jax(luts, res, block, tile_ids, lane0, n):
    if block == "pick":
        block = raygen.pick_block_dims(*res, 2048 if res[0] >= 160 else 64)
        assert block == jrend._pick_block_dims(*res, 2048 if res[0] >= 160 else 64)
    ids = None if tile_ids is None else np.asarray(tile_ids, np.int32)
    tids = None if ids is None else torch.from_numpy(ids)
    cam = _camera(1).params("cpu")
    want_t, want_l, want_pid = _reference_map(res, block, ids, lane0, n)
    for preview in (False, True):
        rays = raygen.gen_rays_plain(KEY, 2, lane0, n, res, block, cam, luts, preview, tids)
        np.testing.assert_array_equal(rays.pid.numpy(), want_pid)
        assert rays.pid.dtype == torch.int64
        if preview:
            np.testing.assert_array_equal(rays.tile_index.numpy(), want_t)
            np.testing.assert_array_equal(rays.lane_index.numpy(), want_l)
            assert rays.tile_index.dtype == rays.lane_index.dtype == torch.int64
        else:
            assert rays.tile_index is None and rays.lane_index is None
        # the lane keys are keyed by that pixel
        want_keys = rng.lane_keys(rng.fold(torch.tensor(KEY, dtype=torch.int64), 2),
                                  torch.from_numpy(want_pid))
        assert torch.equal(rays.keys, want_keys)


# --- the kernel's parameter block ------------------------------------------------

def _block_read_back(base_key, spp, lane0, image_res, block, cam, cie_cdf, preview):
    """The parameter block read back from the camera and CIE tensors (the
    recipe kernel_params followed before it took host values)."""
    w, h = image_res
    cpu_cam = CameraParams(*(t.detach().to("cpu", torch.float32) for t in cam[:5]), None)
    d, du, dv = camera_basis(cpu_cam)
    fov = np.float32(cpu_cam.fov.item())
    cdf_max = cie_cdf[cie_cdf.shape[0] - 1].tolist()
    fparams = [*d.tolist(), *du.tolist(), *dv.tolist(), float(np.float32(2.0) * fov),
               float(fov), float(fov * np.float32(w / h)), float(cpu_cam.aspect_scale.item()),
               *raygen._seq(spp), *cdf_max]
    k0, k1 = base_key
    spp_key = rng.threefry2x32(k0, k1, 0, spp & rng.M32)
    pix_key = rng.threefry2x32(k0, k1, 0, raygen._PIXEL_DOMAIN)
    iparams = [*spp_key, *pix_key, lane0, w, h, block[0], block[1],
               cie_cdf.shape[0], 1 if preview else TraceConfig().hero_lambdas, int(preview), 1]
    return fparams, iparams


def _tensor_camera(r, device):
    """The Renderer's camera as float32 tensors made from its float64 state."""
    f32 = dict(dtype=torch.float32, device=device)
    return CameraParams(torch.tensor(r.camera_pos, **f32), torch.tensor(r.look_at, **f32),
                        torch.tensor(r.up, **f32), torch.tensor(r.fov, **f32),
                        torch.tensor(r.aspect_scale, **f32), None)


PARAM_CASES = [(scene, res, mode) for scene in SCENES for res in ((1920, 1080), (480, 270))
               for mode in ("path", "preview")]


@pytest.mark.parametrize("scene,res,mode", PARAM_CASES)
def test_parameter_block_from_host_values(atlas, luts, scene, res, mode):
    r = _renderer(atlas, scene, res, mode)
    preview = mode == "preview"
    block = r.block if preview else (1, res[1])
    for spp, lane0 in ((0, 0), (7, res[0] * res[1] // 3)):
        got = raygen.kernel_params(r._seed_key, spp, lane0, res, block, r.camera_params("cpu"),
                                   luts, preview)
        want = _block_read_back(r._seed_key, spp, lane0, res, block,
                                _tensor_camera(r, "cpu"), luts.cie_cdf, preview)
        assert got == want
        assert len(got[0]) == 19 and len(got[1]) == 13


@pytest.mark.parametrize("scene", SCENES)
def test_parameter_block_reads_no_tensor(atlas, luts, scene):
    """The camera tensors and the tables on ``meta`` hold no data: the block
    comes out the same because it is built from host values alone."""
    r = _renderer(atlas, scene, (1920, 1080))
    meta_luts = tluts.load_spectral_luts("meta")
    assert meta_luts.cie_cdf.is_meta
    cam = r.camera_params("meta")
    assert cam.position.is_meta and cam.host == r.host_camera()
    for preview in (False, True):
        block = r.block if preview else (1, 1080)
        want = raygen.kernel_params(r._seed_key, 3, 0, (1920, 1080), block,
                                    r.camera_params("cpu"), luts, preview)
        got = raygen.kernel_params(r._seed_key, 3, 0, (1920, 1080), block, cam, meta_luts,
                                   preview)
        assert got == want


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 7])
def test_spp_key_on_the_host_is_fold(seed):
    """The preview's spp key from Python integers equals rng.fold's."""
    base = (0, seed & rng.M32)
    for spp in (0, 1, 17, 2**20 + 3):
        want = rng.fold(torch.tensor(base, dtype=torch.int64), spp)
        assert torch.equal(raygen.spp_key(base, spp), want)


def test_host_camera_rounds_as_torch_does():
    g = np.random.default_rng(5)
    vals = g.normal(size=3) * 1e7, g.normal(size=3), g.normal(size=3), g.uniform(), g.uniform()
    host = HostCamera.of(*vals)
    for got, v in zip(host.params("cpu")[:5], vals):
        assert torch.equal(got, torch.tensor(v, dtype=torch.float32))
    assert host.params("cpu").host is host


@pytest.mark.parametrize("lane0,n,n_lambdas,match", [
    (2**31 - 100, 100, 4, "2\\^31"), (-1, 10, 4, "2\\^31"), (0, 10, 3, "wavelengths"),
    (0, 10, 2, "wavelengths"),
])
def test_launcher_checks_lanes_and_packet(luts, lane0, n, n_lambdas, match):
    """The launcher refuses lanes outside [0, 2^31), and a parameter block
    whose packet is not the call's (any width is taken: outside 1 and 4 from
    its width library), before anything is built or launched."""
    g, _ = tluts.ray_tables(luts)
    fparams = [0.0] * 19
    block_l = 4 if match == "wavelengths" else n_lambdas
    iparams = [0, 0, 0, 0, lane0, 32, 18, 1, 18, g.shape[0], block_l, 0, 1]
    with pytest.raises(ValueError, match=match):
        kernels.gen_rays(fparams, iparams, g, luts.cie_response, n, n_lambdas)


# --- trace_lanes with the pixel map from ray generation ------------------------------

SMALL = TraceConfig(max_bounces=3, land_march_steps=64, max_tracking_steps=256)


def _trace_recomputed(base_key, spp, lane0, n, cam, scene, atlas, luts, image_res, block, cfg,
                      color, count=None, lum2=None, mode="path", tile_ids=None):
    """trace_lanes with the pixel map recomputed from the lane ids and the
    origin expanded from the camera tensor (its steps before ray generation
    returned the map)."""
    _, h = image_res
    preview = mode == "preview"
    rays = raygen.gen_rays(base_key, spp, lane0, n, image_res, block, cam, luts, preview,
                           tile_ids)
    lane = torch.arange(lane0, lane0 + n, dtype=torch.int64)
    tidx, li, pu, pv = raygen.tile_pixel_coords(lane, image_res, block, tile_ids)
    pid = pu * h + pv
    pos = cam.position.expand(n, 3).contiguous()
    if preview:
        spp_key = rng.fold(torch.tensor(base_key, dtype=torch.int64), spp)
        radiance = raymarcher.march_paths(
            spp_key, pos, rays.dirs, rays.wavelengths[:, 0], scene, atlas, luts, cfg,
            tile_index=tidx, lane=li, tile=block[0] * block[1])
        fe.frame_end(rays.responses, pid, color, count, lum2, radiance=radiance[:, None],
                     pdf=rays.pdf)
        return
    st = pt.init_state(pos, rays.dirs, rays.wavelengths, rays.pdf, rays.keys)
    st = pt.run_bounces(st, scene, atlas, luts, cfg, 0, cfg.max_bounces)
    fe.frame_end(rays.responses, pid, color, count, lum2,
                 miss=fe.MissShading(st, scene, atlas, luts, cfg))


@pytest.mark.parametrize("mode,tiles", [("path", None), ("preview", None), ("path", [5, 0, 11])])
def test_trace_lanes_frame_bit_equal_after_the_map_moved(atlas, mode, tiles):
    res = (32, 18)
    # 64-pixel tiles: twelve of them, each keying its own preview draws
    r = _renderer(atlas, "config - Apollo 11.txt", res, mode, SMALL, tile_pixels=64)
    assert r.tile < res[0] * res[1]
    ids = None if tiles is None else torch.tensor(tiles, dtype=torch.int32)
    block = r.block if (mode == "preview" or ids is not None) else (1, res[1])
    n = res[0] * res[1] if ids is None else len(tiles) * r.tile
    outs = []
    for trace in (trace_lanes, _trace_recomputed):
        color = torch.zeros((res[0] * res[1], 3))
        count, lum2 = torch.zeros(res[0] * res[1]), torch.zeros(res[0] * res[1])
        trace(r._seed_key, 1, 0, n, r.camera_params(), r.scene_params(), r.atlas, r.luts, res,
              block, SMALL, color, count, lum2, mode=mode, tile_ids=ids)
        outs.append((color, count, lum2))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert outs[0][1].sum().item() == n and outs[0][0].abs().sum().item() > 0


# --- the reference estimator's primary samples and packet ---------------------------

def _jax_rays(res, spp, cam_args, luts_j, stratify, n_lambdas, preview):
    """The reference's gen_rays and wavelength sampling (renderer.py:160-194,
    202-216) on every lane of a path-ordered frame (blocks of (1, H)),
    composed from the JAX package's own functions."""
    import jax

    from digital_earth_tpu.ops import rng as jrng
    from digital_earth_tpu.ops import spectral as jsp
    from digital_earth_tpu.render import camera as jcam

    w, h = res
    pid = jnp.arange(w * h)
    pu, pv = (pid // h).astype(jnp.float32), (pid % h).astype(jnp.float32)
    base = jax.random.PRNGKey(KEY[1])
    lkeys = jrng.lane_keys(jax.random.fold_in(base, spp), pid)
    if stratify:
        pkeys = jrng.lane_keys(jax.random.fold_in(base, jrend._PIXEL_DOMAIN), pid)
        shift = jrng.uniform(jrng.fold(pkeys, jrend._SITE_JITTER), (3,))
        seq = (jnp.asarray(jrend._R3_A32, jnp.uint32) * jnp.uint32(spp + 1)).astype(
            jnp.float32) * jnp.float32(2.0**-32)
        u3 = jnp.mod(shift + seq[:, None], 1.0)
        u_jit, u = u3[:2], u3[2]
    else:
        u_jit = jrng.uniform(jrng.fold(lkeys, jrend._SITE_JITTER), (2,))
        u = jrng.uniform(jrng.fold(lkeys, jrend._SITE_WL))
    dirs = jcam.cast_dirs(jcam.make_camera_params(**cam_args), pu, pv, u_jit[0], u_jit[1], res)
    if preview:
        wl, _, pdf = jsp.spectrum_sample(u, luts_j.cie_cdf, luts_j.cie_response)
        wl, pdf = wl[:, None], pdf[:, None]
    else:
        wl, _, pdf = jsp.spectrum_sample_hero(u, luts_j.cie_cdf, luts_j.cie_response, n_lambdas)
    return (np.asarray(lkeys).astype(np.int64), np.asarray(dirs), np.asarray(wl),
            np.asarray(pdf))


@pytest.mark.parametrize("stratify,n_lambdas,preview", [
    (False, 4, False), (True, 1, False), (False, 1, False), (False, 1, True),
])
def test_reference_estimator_rays_match_jax(luts, stratify, n_lambdas, preview):
    """``gen_rays_plain`` at ``stratify_spp=False`` (the reference's
    independent jitter and wavelength draws from the lane key) and at
    ``hero_lambdas=1`` against the reference's ray generation on the same
    48x27 frame: the lane keys bit-equal, the directions within cast_dirs'
    atol 1e-6, the wavelengths and the lambda pdf within
    spectrum_sample_hero's rtol 1e-5 / atol 1e-6 on 0.999 of the values
    (tests/test_torch_elementwise.py); the preview (one wavelength, 1 / pdf)
    takes the unstratified draws as the reference's preview does, within
    spectrum_sample's rtol 5e-6 and 2e-4 (tests/test_torch_preview.py)."""
    from digital_earth_tpu.assets.luts import load_spectral_luts as jax_luts
    from digital_earth_tpu_torch import convert
    from digital_earth_tpu.render import camera as jcam

    res, spp = (48, 27), 5
    cam_args = dict(position=(3.6e7, 1.2e7, -4.2e7), look_at=(2.3e7, 8.3e6, -2.6e7),
                    up=(0.26, 0.675, -0.69), fov=0.127, aspect_scale=0.997)
    cam = convert.camera_params_to_torch(jcam.make_camera_params(**cam_args), "cpu")
    cfg = TraceConfig(stratify_spp=stratify, hero_lambdas=n_lambdas)
    n = res[0] * res[1]
    rays = raygen.gen_rays_plain(KEY, spp, 0, n, res, (1, res[1]), cam, luts, preview, cfg=cfg)
    keys, dirs, wl, pdf = _jax_rays(res, spp, cam_args, jax_luts(), stratify, n_lambdas, preview)
    np.testing.assert_array_equal(rays.keys.numpy(), keys)
    np.testing.assert_allclose(rays.dirs.numpy(), dirs, atol=1e-6)
    assert rays.wavelengths.shape == rays.pdf.shape == (n, 1 if preview else n_lambdas)
    if preview:
        np.testing.assert_allclose(rays.wavelengths.numpy(), wl, rtol=5e-6)
        np.testing.assert_allclose(rays.pdf.numpy(), pdf, rtol=2e-4)
    else:
        for got, want in ((rays.wavelengths, wl), (rays.pdf, pdf)):
            assert np.isclose(got.numpy(), want, rtol=1e-5, atol=1e-6).mean() >= 0.999
    # the kernel's parameter block carries the mode and the packet width
    _, ip = raygen.kernel_params(KEY, spp, 0, res, (1, res[1]), cam, luts, preview, cfg)
    assert ip[10:] == [1 if preview else n_lambdas, int(preview), int(stratify)]
