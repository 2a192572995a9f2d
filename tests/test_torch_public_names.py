"""The rest of the JAX package's public surface in the port: the config
names (`tiny_config`, `LGUnetConfig.in_chans`/`out_chans`), the four
`cli` wrappers and the shell scripts scripts/torch_run_da.sh and
scripts/torch_train_vae.sh, which carry scripts/run_da.sh's and
scripts/train_vae.sh's flags to the port's CLIs. (tests/test_torch_import.py
holds the `channels` copies; tests/test_torch_vae_train.py holds the NMC
batches, which now go through `channels.normalize`, bitwise to JAX's.)"""

import dataclasses
import re
import shlex
import subprocess
from pathlib import Path

import pytest

from vaevar_tpu import config as jcfg
from vaevar_tpu_torch import cli, run_da, run_train_vae
from vaevar_tpu_torch import config as tcfg

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {"torch_run_da.sh": ("run_da.sh", "python run_da.py",
                               "python -m vaevar_tpu_torch.run_da", run_da.arg_parser),
           "torch_train_vae.sh": ("train_vae.sh", "python run_train_vae.py",
                                  "python -m vaevar_tpu_torch.run_train_vae",
                                  run_train_vae.arg_parser)}


@pytest.mark.parametrize("kw", [{}, dict(attn_type="relbias"),
                                dict(img_size=(16, 32), lg_full_attn_first=False)])
def test_tiny_config_equals_reference(kw):
    assert dataclasses.asdict(tcfg.tiny_config(**kw)) == dataclasses.asdict(jcfg.tiny_config(**kw))


def test_in_and_out_chans_equal_reference():
    pairs = [(getattr(tcfg, n), getattr(jcfg, n))
             for n in ("FORECAST_025", "FLOW_140", "VAE_ENCODER", "VAE_DECODER")]
    pairs += [(tcfg.micro_config(), jcfg.micro_config()), (tcfg.tiny_config(), jcfg.tiny_config()),
              *zip(tcfg.micro_vae_configs(), jcfg.micro_vae_configs())]
    for t, j in pairs:
        assert (t.in_chans, t.out_chans) == (j.in_chans, j.out_chans)
    assert (tcfg.FORECAST_025.in_chans, tcfg.FORECAST_025.out_chans) == (69, 138)
    assert (tcfg.VAE_DECODER.in_chans, tcfg.VAE_DECODER.out_chans) == (32, 69)


@pytest.mark.parametrize("name, module", [("da_main", "run_da"),
                                          ("train_vae_main", "run_train_vae"),
                                          ("train_forecast_main", "run_train_forecast"),
                                          ("convert_ckpt_main", "convert_ckpt")])
def test_cli_wrappers_call_the_ports_mains(name, module, monkeypatch):
    import importlib

    mod = importlib.import_module(f"vaevar_tpu_torch.{module}")
    calls = []
    monkeypatch.setattr(mod, "main", lambda *a, **k: calls.append((a, k)))
    getattr(cli, name)()
    assert calls == [((), {})]


def _body(path):
    """The script without its comment lines."""
    return "\n".join(line for line in path.read_text().splitlines()
                     if not line.lstrip().startswith("#"))


def _flags(path, command):
    """The words the script passes after `command`, up to "$@"."""
    text = _body(path).replace("\\\n", " ")
    (line,) = [ln for ln in text.splitlines() if command in ln]
    words = shlex.split(line.split(command, 1)[1])
    return words[:words.index("$@")]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_scripts_pass_the_pre_port_flags(script):
    ref, ref_cmd, cmd, parser = SCRIPTS[script]
    path, ref_path = REPO / "scripts" / script, REPO / "scripts" / ref
    subprocess.run(["bash", "-n", str(path)], check=True)
    flags = _flags(path, cmd)
    assert flags and flags == _flags(ref_path, ref_cmd)
    # the same loop and options; only the program differs
    assert _body(path).replace(cmd, ref_cmd) == _body(ref_path)
    args = parser([re.sub(r"^\$\{\w+:-\}$", "", w) for w in flags])
    for flag, value in zip(flags[::2], flags[1::2]):
        got = getattr(args, flag[2:])
        assert got in ("", None) if value.startswith("${") else got == type(got)(value), flag
