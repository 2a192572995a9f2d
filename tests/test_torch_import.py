"""The port imports no JAX and none of the JAX package.

Every vaevar_tpu_torch module imports in a fresh interpreter where jax, flax,
optax and pandas cannot be imported (the chip machine has no pandas), and no
vaevar_tpu module gets loaded; no source file of the port (or chip_smoke.py)
names them. The few jax-free
tables the port carries as copies (channel registry, model and DA configs
and `from_reference_dict`, the ERA5 sources and stores, the native loader
binding, `reference_state_dict`, `lgunet_block_from_yaml`, the
relative-position index, the synthetic obs masks, R and the model error Q,
the batch prefetcher, the SHT's quadrature weights and Legendre table, the
observation-level ladder and matrices, the station and real-obs gridding
and the report sources, the OSSE's SharedModeEra5, the training meters and
the phase timer,
the positional encodings, rope3's tables and the SD_attn mask) are held
equal to the reference here."""

import dataclasses
import inspect
import json
import re
import subprocess
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest

from vaevar_tpu import channels as jch
from vaevar_tpu.data import era5 as jera5
from vaevar_tpu.data import native_loader as jnative
from vaevar_tpu.utils import port_torch
from vaevar_tpu import config as jcfg
from vaevar_tpu.da import obs as jobs
from vaevar_tpu.data import prefetch as jprefetch
from vaevar_tpu.data import reports as jreports
from vaevar_tpu.ops import interp as jinterp
from vaevar_tpu.data.era5 import SyntheticEra5 as JaxEra5
from vaevar_tpu.ops import posenc as jposenc
from vaevar_tpu.ops import rope as jrope
from vaevar_tpu.ops import sht as jsht
from vaevar_tpu.ops import windows as jwindows
from vaevar_tpu.ops.posenc import relative_position_index as j_rpi
from vaevar_tpu_torch import channels as tch
from vaevar_tpu_torch import config as tcfg
from vaevar_tpu_torch import convert_ckpt as tconvert
from vaevar_tpu_torch.data import era5 as tera5
from vaevar_tpu_torch.data import native_loader as tnative
from vaevar_tpu_torch.train import checkpoint as tckpt
from vaevar_tpu_torch.da import obs as tobs
from vaevar_tpu_torch.data import prefetch as tprefetch
from vaevar_tpu_torch.data import reports as treports
from vaevar_tpu_torch.ops import interp as tinterp
from vaevar_tpu_torch.data.era5 import SyntheticEra5 as TorchEra5
from vaevar_tpu_torch.ops import posenc as tposenc
from vaevar_tpu_torch.ops import rope as trope
from vaevar_tpu_torch.ops import sht as tsht
from vaevar_tpu_torch.ops import windows as twindows
from vaevar_tpu_torch.ops.posenc import relative_position_index as t_rpi

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "vaevar_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, json\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas'):\n"
        "    sys.modules[m] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        "                        if k == 'vaevar_tpu' or k.startswith('vaevar_tpu.'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert len(_modules()) >= 20


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_sources_name_no_jax(path):
    src = (REPO / path).read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|pandas|vaevar_tpu)\b"
                     r"(?!_torch)",
                     src, flags=re.M)
    assert not bad, (path, bad)


def test_channel_tables_equal_reference():
    for name in ("MEAN", "STD", "ERR_STD"):
        np.testing.assert_array_equal(getattr(tch, name), getattr(jch, name))
    assert tch.CHANNEL_NAMES == jch.CHANNEL_NAMES and tch.IDX == jch.IDX
    assert (tch.N_CHANNELS, tch.N_SINGLE, tch.N_LEVELS) == (jch.N_CHANNELS, jch.N_SINGLE,
                                                            jch.N_LEVELS)


def test_channel_helpers_copy_equals_reference():
    assert tch.DEFAULT_INCHANS_LIST == jch.DEFAULT_INCHANS_LIST
    x = np.random.default_rng(0).normal(size=(2, 69, 3, 4)).astype(np.float32)
    for name in ("normalize", "denormalize"):
        assert inspect.getsource(getattr(tch, name)) == inspect.getsource(getattr(jch, name))
        for axis in (-3, 1):
            np.testing.assert_array_equal(getattr(tch, name)(x, axis=axis),
                                          getattr(jch, name)(x, axis=axis))


def test_configs_equal_reference():
    assert [f.name for f in dataclasses.fields(tcfg.LGUnetConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.LGUnetConfig)]
    for name in ("FORECAST_025", "FLOW_140", "VAE_ENCODER", "VAE_DECODER"):
        assert dataclasses.asdict(getattr(tcfg, name)) == dataclasses.asdict(getattr(jcfg, name))
    for a, b in ((tcfg.micro_config(), jcfg.micro_config()),
                 (tcfg.micro_config(img_size=(32, 64), attn_type="relbias"),
                  jcfg.micro_config(img_size=(32, 64), attn_type="relbias")),
                 *zip(tcfg.micro_vae_configs((32, 64)), jcfg.micro_vae_configs((32, 64)))):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    jda = dataclasses.asdict(jcfg.DAConfig())
    for k, v in dataclasses.asdict(tcfg.DAConfig()).items():
        assert jda[k] == v, k


def test_synthetic_source_equals_reference():
    t = datetime(2022, 1, 1, 6)
    np.testing.assert_array_equal(TorchEra5(hw=(32, 64), seed=3).get_state(t),
                                  JaxEra5(hw=(32, 64), seed=3).get_state(t))


def test_obs_and_posenc_copies_equal_reference():
    for tp in range(5):
        np.testing.assert_array_equal(tobs.obs_error_variance(0.005, tp),
                                      jobs.obs_error_variance(0.005, tp))
    var = jobs.obs_error_variance(0.005, 2)
    np.testing.assert_array_equal(tobs.build_R(var, None, 1), jobs.build_R(var, None, 1, (8, 8)))
    for kind in ("free_0001", "column_random_0001"):
        np.testing.assert_array_equal(
            tobs.make_obs_mask(kind, 1, (64, 128), np.random.default_rng(4)),
            jobs.make_obs_mask(kind, 1, (64, 128), np.random.default_rng(4)))
    for win in ((4, 4), (6, 12)):
        np.testing.assert_array_equal(t_rpi(win), j_rpi(win))


@pytest.mark.parametrize("q_type, files", [(1, None), (1, "new_q"), (0, "q"), (-1, None)])
def test_q_matrix_and_R_copies_equal_reference(tmp_path, q_type, files):
    """load_q_matrix and build_R with Q: q_type 1 with new_q.npy and without
    it (the synthetic Q linear in lead), q_type 0 (spatial means of q<i>.npy)
    and -1 (none), at da_win 6; and R for da_win 1, where Q never applies."""
    rng = np.random.default_rng(7)
    if files == "new_q":
        np.save(tmp_path / "new_q.npy", rng.random((8, 69)).astype(np.float32))
    elif files == "q":
        for i in range(1, 6):
            np.save(tmp_path / f"q{i}.npy", rng.random((69, 12, 24)).astype(np.float32))
    var = jobs.obs_error_variance(0.005, 2)
    for win in (1, 6):
        q_t = tobs.load_q_matrix(str(tmp_path), q_type, win)
        q_j = jobs.load_q_matrix(str(tmp_path), q_type, win, (12, 24))
        assert (q_t is None) == (q_j is None) == (win == 1 or q_type == -1)
        if q_t is not None:
            assert q_t.shape == (win - 1, 69, 1, 1)
            np.testing.assert_array_equal(q_t, q_j)
        R = tobs.build_R(var, q_t, win)
        np.testing.assert_array_equal(R, jobs.build_R(var, q_j, win, (12, 24)))
        assert R.shape == (win, 69, 1, 1)
    per_pixel = rng.random((5, 69, 12, 24)).astype(np.float32)
    np.testing.assert_array_equal(tobs.build_R(var, per_pixel, 6),
                                  jobs.build_R(var, per_pixel, 6, (12, 24)))


def test_prefetch_copy_equals_reference():
    assert inspect.getsource(tprefetch.prefetched) == inspect.getsource(jprefetch.prefetched)
    assert list(tprefetch.prefetched(range(50), depth=3)) == list(range(50))


def _src(obj):
    """Source text with the port's package name read as the reference's."""
    return inspect.getsource(obj).replace("vaevar_tpu_torch", "vaevar_tpu")


def test_from_reference_dict_copy_equals_reference():
    assert _src(tcfg.LGUnetConfig.from_reference_dict) == \
        inspect.getsource(jcfg.LGUnetConfig.from_reference_dict)
    block = {"img_size": [721, 1440], "patch_size": [3, 2], "inchans_list": [4, 13],
             "outchans_list": [8, 26], "window_size": [6, 12], "enc_depths": [2, 2, 2],
             "enc_heads": [3, 6, 6], "lg_depths": [4], "lg_heads": [6], "rank": 2,
             "use_checkpoint": True}
    for attn in ("rope", "relbias"):
        assert dataclasses.asdict(tcfg.LGUnetConfig.from_reference_dict(block, attn)) == \
            dataclasses.asdict(jcfg.LGUnetConfig.from_reference_dict(block, attn))


def test_checkpoint_helper_copies_equal_reference():
    assert _src(tckpt.reference_state_dict) == inspect.getsource(port_torch.reference_state_dict)
    sys.path.insert(0, str(REPO / "scripts"))
    import convert_ckpt as jconvert

    assert _src(tconvert.lgunet_block_from_yaml) == \
        inspect.getsource(jconvert.lgunet_block_from_yaml)


def test_shared_mode_source_copy_equals_reference():
    """SharedModeEra5's numpy code and `_smooth_noise`, line for line (its
    states and models are held bitwise in tests/test_torch_osse.py); its
    advect_model and hourly_apply are the port's own torch rolls."""
    assert _src(tera5._smooth_noise) == inspect.getsource(jera5._smooth_noise)
    for name in ("__init__", "_to_hours", "get_state"):
        assert _src(getattr(tera5.SharedModeEra5, name)) == \
            inspect.getsource(getattr(jera5.SharedModeEra5, name)), name
    assert tera5.SharedModeEra5.__doc__ == jera5.SharedModeEra5.__doc__


def test_parallel_and_meters_copies_equal_reference():
    """The port's parallel package imports no JAX (the subprocess check
    above covers it) and has the counterparts of the JAX package's dp
    surface. The meters module's MetricLogger and SmoothedValue, and the
    logger's PhaseTimer, are copies of the JAX package's, but for
    SmoothedValue.synchronize_between_processes, which reduces over
    torch.distributed (tests/test_torch_meters.py holds it to JAX's)."""
    from vaevar_tpu.utils import logger as jlogger
    from vaevar_tpu.utils import meters as jmeters
    from vaevar_tpu_torch.parallel import mesh as tmesh
    from vaevar_tpu_torch.utils import logger as tlogger
    from vaevar_tpu_torch.utils import meters as tmeters

    assert "vaevar_tpu_torch.parallel.mesh" in _modules()
    for name in ("process_index", "process_count", "init_distributed", "mesh_from_arg",
                 "global_batch", "check_replicas"):
        assert callable(getattr(tmesh, name)), name
    assert callable(tmeters.ScalarWriter)
    assert inspect.getsource(tmeters.MetricLogger) == inspect.getsource(jmeters.MetricLogger)
    assert inspect.getsource(tlogger.PhaseTimer) == inspect.getsource(jlogger.PhaseTimer)
    for name, ref in vars(jmeters.SmoothedValue).items():
        if name == "synchronize_between_processes" or not callable(getattr(ref, "fget", ref)):
            continue
        port = vars(tmeters.SmoothedValue)[name]
        assert inspect.getsource(getattr(port, "fget", port)) == \
            inspect.getsource(getattr(ref, "fget", ref)), name


def test_store_and_native_binding_copies_equal_reference():
    """The stores' reading code and the binding's methods, line for line;
    the port's ReferenceLayoutStore.__init__ differs only in recording its
    reader, NativePrefetcher.__init__ in its error message."""
    assert _src(tera5._stamp) == inspect.getsource(jera5._stamp)
    assert _src(tera5.LocalNpyStore) == inspect.getsource(jera5.LocalNpyStore)
    for name in ("_stamp_parts", "_paths", "get_state", "has"):
        assert _src(getattr(tera5.ReferenceLayoutStore, name)) == \
            inspect.getsource(getattr(jera5.ReferenceLayoutStore, name)), name
    assert _src(tnative.LoaderSampleError) == inspect.getsource(jnative.LoaderSampleError)
    for name in ("submit", "next", "next_tagged", "pending", "close", "__del__"):
        assert _src(getattr(tnative.NativePrefetcher, name)) == \
            inspect.getsource(getattr(jnative.NativePrefetcher, name)), name


@pytest.mark.parametrize("n", [32, 33, 128, 721])
def test_sht_table_copies_equal_reference(n):
    """The quadrature weights and the Legendre table (of the n x 2n grid),
    line for line and bitwise: the same numpy code in float64."""
    for name in ("clenshaw_curtis_weights", "_legendre_table"):
        assert inspect.getsource(getattr(tsht, name)) == inspect.getsource(getattr(jsht, name))
    np.testing.assert_array_equal(tsht.clenshaw_curtis_weights(n),
                                  jsht.clenshaw_curtis_weights(n))
    if n <= 128:
        np.testing.assert_array_equal(tsht._legendre_table(n, n, n + 1),
                                      jsht._legendre_table(n, n, n + 1))


@pytest.mark.parametrize("module, name", [
    ("interp", "obs_height_levels"), ("interp", "obs_level_interp_matrix"),
    ("interp", "obs_level_interp_matrix_inv"), ("interp", "_log_linear_matrix"),
    ("obs", "make_obs_mask"), ("obs", "_report_fields"), ("obs", "_grid_indices"),
    ("obs", "_time_slot"), ("obs", "station_mask_from_reports"),
    ("obs", "_geopotential_coeff"), ("obs", "_temperature_coeff"), ("obs", "grid_real_obs"),
    ("obs", "std_layer_augmented"), ("reports", "_stamp"),
    ("reports", "LocalReportsStore"), ("reports", "SyntheticReports")])
def test_real_obs_copies_equal_reference(module, name):
    """The numpy code of the real-obs path, line for line (its behaviour is
    held bitwise in tests/test_torch_real_obs.py)."""
    port, ref = {"interp": (tinterp, jinterp), "obs": (tobs, jobs),
                 "reports": (treports, jreports)}[module]
    assert _src(getattr(port, name)) == inspect.getsource(getattr(ref, name))
    if module == "obs":
        np.testing.assert_array_equal(tobs._STATION_HEIGHT_BINS, jobs._STATION_HEIGHT_BINS)


@pytest.mark.parametrize("name, args", [
    ("_axis_emb", (7, 5)), ("positional_encoding_1d", (10, 6)),
    ("positional_encoding_2d", (4, 8, 10)), ("positional_encoding_3d", (2, 4, 8, 12)),
    ("build_2d_sincos_posemb", (4, 8, 64)), ("relative_position_onehot", ((2, 3, 4),)),
    ("relative_position_index", ((6, 12),))])
def test_posenc_copy_equals_reference(name, args):
    """ops/posenc.py is a copy of the reference module, function for
    function: the same source and bitwise the same tables."""
    assert inspect.getsource(getattr(tposenc, name)) == inspect.getsource(getattr(jposenc, name))
    np.testing.assert_array_equal(getattr(tposenc, name)(*args), getattr(jposenc, name)(*args))


def test_sd_attn_copies_equal_reference():
    """rope3_tables, sd_attention_mask and the config's validation of the
    SD_attn fields, line for line (their values are held bitwise in
    tests/test_torch_sd_attn.py)."""
    assert inspect.getsource(trope.rope3_tables) == inspect.getsource(jrope.rope3_tables)
    assert inspect.getsource(twindows.sd_attention_mask) == \
        inspect.getsource(jwindows.sd_attention_mask)
    assert inspect.getsource(tcfg.LGUnetConfig.__post_init__) == \
        inspect.getsource(jcfg.LGUnetConfig.__post_init__)
    for bad in (dict(window_size=(1, 2, 2)), dict(lg_window_size=(2, 2, 4))):
        with pytest.raises(ValueError):
            tcfg.LGUnetConfig(**bad)
