"""``setup`` of the port (``sofa_tpu_torch/setup_env.py``): the JAX
package's recipes (``tests/test_cli.py``'s setup tests) with the device
probe made CUDA's — a ``torch.cuda`` probe in a subprocess under the same
30 s timeout, whose hang, failure and healthy paths are tested here with
the subprocess faked, and once for real on this host, which has no card:
nothing claims "healthy" without one.  Also the CLI's 25 verbs (the JAX
CLI's set) and ``--apply``'s two meanings.
"""

import re
import subprocess as sp

import pytest

from sofa_tpu_torch import setup_env
from sofa_tpu_torch.cli import VERBS, build_parser, config_from_args, main

H100 = "NVIDIA H100 80GB HBM3"


class _Done:
    def __init__(self, returncode=0, stdout="", stderr=""):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def test_setup_check_mode(capsys):
    rc = main(["setup", "--no-device-probe"])
    out = capsys.readouterr()
    assert rc in (0, 1)
    assert "perf_event_paranoid" in out.out + out.err


def test_setup_apply_uses_runner(monkeypatch):
    ran = []
    monkeypatch.setattr(setup_env, "check",
                        lambda utilities=None, probe_device=True:
                        (["sysctl -w a=b"], 1))
    rc = setup_env.sofa_setup(apply=True,
                              runner=lambda c: ran.append(c) or 0)
    assert rc == 0 and ran == ["sysctl -w a=b"]


def test_setup_reports_fixes_without_apply(monkeypatch, capsys):
    monkeypatch.setattr(setup_env, "check",
                        lambda utilities=None, probe_device=True:
                        (["setcap x /bin/tcpdump"], 1))
    assert setup_env.sofa_setup(apply=False) == 1
    assert "setcap x /bin/tcpdump" in capsys.readouterr().out


def test_probe_hang_is_bounded_names_the_cuda_driver(monkeypatch, capsys):
    seen = {}

    def hang(cmd, **kw):
        seen.update(kw, cmd=cmd)
        raise sp.TimeoutExpired(cmd="probe", timeout=kw["timeout"])

    monkeypatch.setattr(setup_env.subprocess, "run", hang)
    assert setup_env._probe_backend() is False
    text = "".join(capsys.readouterr())
    assert "hung > 30s" in text and "CUDA driver" in text
    assert seen["timeout"] == 30.0
    assert "torch.cuda.is_available()" in seen["cmd"][-1]
    assert "get_device_name(0)" in seen["cmd"][-1]


def test_probe_failure_is_a_problem(monkeypatch, capsys):
    monkeypatch.setattr(
        setup_env.subprocess, "run", lambda *a, **k: _Done(
            1, "", "Traceback\nSystemExit: torch.cuda.is_available() is "
                   "False (no card visible to the CUDA driver)\n"))
    assert setup_env._probe_backend() is False
    text = "".join(capsys.readouterr())
    assert "init failed (CUDA driver)" in text and "is False" in text
    assert "healthy" not in text


def test_probe_healthy_names_the_card(monkeypatch, capsys):
    monkeypatch.setattr(setup_env.subprocess, "run",
                        lambda *a, **k: _Done(0, f"cuda 1 {H100}\n"))
    assert setup_env._probe_backend() is True
    assert f"device backend healthy: cuda (1 device(s), {H100})" in \
        capsys.readouterr().out


def test_unusable_backend_counts_as_a_problem(monkeypatch):
    monkeypatch.setattr(setup_env, "_probe_backend", lambda: False)
    _fixes, with_probe = setup_env.check()
    monkeypatch.setattr(setup_env, "_probe_backend", lambda: True)
    _fixes, healthy = setup_env.check()
    assert with_probe == healthy + 1
    _fixes, skipped = setup_env.check(probe_device=False)
    assert skipped == healthy


def test_real_probe_on_a_host_without_a_card(capsys):
    """This host has no card: the probe (a real subprocess importing
    torch) reports failure, and setup exits 1, never 'fully enabled'."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    assert setup_env._probe_backend() is False
    assert main(["setup"]) == 1
    out = "".join(capsys.readouterr())
    assert "device backend healthy" not in out
    assert "fully enabled" not in out


def test_empower_unknown_utility_is_refused(monkeypatch, capsys):
    monkeypatch.setattr(setup_env, "_probe_backend", lambda: True)
    _fixes, problems = setup_env.check(["definitely-not-a-tool"])
    _fixes, base = setup_env.check()
    assert problems == base + 1
    assert "refusing to guess" in "".join(capsys.readouterr())


def test_apply_bare_for_setup_valued_for_whatif(monkeypatch):
    seen = {}

    def fake_setup(utilities=None, apply=False, runner=None,
                   probe_device=True):
        seen.update(utilities=utilities, apply=apply,
                    probe_device=probe_device)
        return 0

    monkeypatch.setattr(setup_env, "sofa_setup", fake_setup)
    assert main(["setup", "--apply", "--empower", "tcpdump",
                 "--no-device-probe"]) == 0
    assert seen == {"utilities": ["tcpdump"], "apply": True,
                    "probe_device": False}
    assert main(["setup"]) == 0
    assert seen["apply"] is False and seen["probe_device"] is True
    args = build_parser().parse_intermixed_args(
        ["whatif", "/tmp/x", "--apply", "overlap:*,link:2"])
    assert config_from_args(args).whatif_apply == "overlap:*,link:2"
    args = build_parser().parse_intermixed_args(["setup", "--apply"])
    assert config_from_args(args).whatif_apply == ""


def test_help_lists_the_jax_clis_25_verbs(capsys):
    import os

    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "sofa_tpu", "cli.py")).read()
    m = re.search(r'p\.add_argument\("command", choices=\[(.*?)\]\)',
                  src, re.S)
    jax_verbs = set(re.findall(r'"(\w+)"', m.group(1)))
    assert len(VERBS) == 25 and set(VERBS) == jax_verbs
    with pytest.raises(SystemExit):
        main(["--help"])
    out = capsys.readouterr().out
    for verb in ("lint", "artifacts", "protocol", "setup"):
        assert re.search(rf"^  {verb}\s", out, re.M), verb
