"""Docker scoping of perf in the port's ``record``, against the JAX
package's.

The pure helpers (the ``docker run`` anchor, ``_add_cidfile``,
``_perf_cgroup_rel``, ``wrap_docker_command``'s rewrite) give the JAX
functions' outputs on the same inputs: the JAX tests' cases and a
hypothesis strategy of commands.  Then a real ``record`` of a ``docker
run`` through PATH stubs (this host has neither docker nor perf): perf is
scoped to the container's cgroup, falls back to its pid when the
cgroup-scoped perf dies, and never wraps the docker CLI; and the
container gets the port's injection environment.
"""

import os
import stat
import textwrap

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import sofa_tpu.record as jax_record
import sofa_tpu_torch.collectors.perf as perfmod
import sofa_tpu_torch.record as record_mod
from sofa_tpu.collectors.perf import _count_events as jax_count_events
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu_torch.collectors.kineto import KinetoCollector
from sofa_tpu_torch.collectors.perf import PerfCollector, _count_events
from sofa_tpu_torch.config import SofaConfig
from sofa_tpu_torch.record import (DOCKER_ENV_KEYS, _DOCKER_RUN_RE,
                                   _add_cidfile, _perf_cgroup_rel,
                                   sofa_record, wrap_docker_command)

COMMANDS = [
    "docker run --rm img cmd",
    "python train.py",
    "sudo docker run -it img",
    "FOO=1 BAR=x docker run img python t.py",
    "  docker run img",
    "docker runner img",
    "docker  run\timg",
    "echo 'docker run img'",
    "python -c \"import os; os.system('docker run img')\"",
    "dockerd run",
    "sudo  docker run --gpus all img nvidia-smi",
    "A=1 sudo docker run img",
    "1A=2 docker run img",
    "",
]
CGROUPS = [
    # cgroup v1, dockerd over cgroupfs
    "12:perf_event:/docker/abc123\n11:cpu,cpuacct:/docker/abc123\n",
    # v1 with perf_event joined to other controllers
    "5:cpuset,perf_event:/kubepods/pod1/c0ffee\n0::/ignored\n",
    # cgroup v2 only, dockerd over systemd
    "0::/system.slice/docker-abc.scope\n",
    # both: v1's perf_event wins whatever the order
    "0::/v2/path\n3:perf_event:/docker/x\n",
    # the root cgroup, and nothing usable
    "0::/\n",
    "garbage\n1:memory\n",
    "",
]


@pytest.mark.parametrize("command", COMMANDS)
def test_docker_helpers_match_jax_on_the_cases(command):
    assert bool(_DOCKER_RUN_RE.match(command)) == \
        bool(jax_record._DOCKER_RUN_RE.match(command))
    assert _add_cidfile(command, "/tmp/x y.cid") == \
        jax_record._add_cidfile(command, "/tmp/x y.cid")


@pytest.mark.parametrize("text", CGROUPS)
def test_perf_cgroup_rel_matches_jax(text):
    assert _perf_cgroup_rel(text) == jax_record._perf_cgroup_rel(text)


_WORDS = st.sampled_from(["docker", "run", "sudo", "FOO=1", "img", "--rm",
                          "python", "'docker", "run'", "-c", "A=b", "x",
                          "  ", "\t", "dockerd", "runner", "=", "1B=2"])


@settings(max_examples=300, deadline=None)
@given(words=st.lists(_WORDS, max_size=8),
       sep=st.sampled_from([" ", "  ", "\t"]),
       lead=st.sampled_from(["", " ", "  "]))
def test_docker_helpers_match_jax_on_generated_commands(words, sep, lead):
    command = lead + sep.join(words)
    assert bool(_DOCKER_RUN_RE.match(command)) == \
        bool(jax_record._DOCKER_RUN_RE.match(command))
    assert _add_cidfile(command, "/l/docker.cid") == \
        jax_record._add_cidfile(command, "/l/docker.cid")


@settings(max_examples=200, deadline=None)
@given(lines=st.lists(st.tuples(
    st.sampled_from(["0", "1", "12", "x"]),
    st.sampled_from(["", "perf_event", "cpu,perf_event", "memory", "cpu"]),
    st.sampled_from(["/", "/docker/abc", "/system.slice/d.scope", "rel",
                     "/a:b"])), max_size=5))
def test_perf_cgroup_rel_matches_jax_on_generated_dumps(lines):
    text = "\n".join(":".join(t) for t in lines)
    assert _perf_cgroup_rel(text) == jax_record._perf_cgroup_rel(text)


@pytest.mark.parametrize("events", [
    "", "cycles", "cycles,instructions", "cpu/event=0x3c,umask=0x1/,cycles",
    "{cycles,instructions}", "{a,b},c/x=1,y=2/,d"])
def test_scoped_argv_repeats_the_cgroup_per_event_as_jax(logdir, events):
    perf = PerfCollector(SofaConfig(logdir=logdir, perf_events=events))
    perf.mode = "perf"
    argv = perf.scoped_argv("docker/abc")
    n = jax_count_events(events) if events else 1
    assert _count_events(events or "x") == jax_count_events(events or "x")
    assert argv[-3:] == ["-a", "-G", ",".join(["docker/abc"] * n)]
    assert argv[:-3] == perf.attach_argv(7)[:-2]
    perf.mode = "time"
    assert perf.scoped_argv("docker/abc") == []


def test_wrap_docker_command_threads_the_injection_env(logdir):
    cfg = SofaConfig(logdir=logdir, enable_py_stacks=True)
    env = dict(KinetoCollector(cfg).child_env(), UNRELATED="1")
    env["PYTHONPATH"] = env["PYTHONPATH"] + os.pathsep + "/repo"
    got = wrap_docker_command("sudo docker run --gpus all img python t.py",
                              cfg, env)
    head, tail = got.split(" img python t.py")
    assert tail == "" and head.startswith("sudo docker run ")
    absdir = os.path.abspath(logdir)
    assert f"-v {absdir}:{absdir}" in head
    # every injection key the collector set, and nothing else of the env
    for key in DOCKER_ENV_KEYS:
        if key in env:
            assert f"-e {key}=" in head or f"-e '{key}=" in head, key
    assert "SOFA_TORCH_KINETO_OPTS" in head and "PYTHONPATH" in head
    assert "SOFA_TORCH_PYSTACKS_HZ=67" in head
    assert "UNRELATED" not in head and "--gpus all" in head
    assert set(DOCKER_ENV_KEYS) >= {k for k in env if k.startswith("SOFA_")}
    # over the keys both packages thread (none, or PYTHONPATH alone) the
    # rewrite is the JAX package's, byte for byte
    jcfg = JaxConfig(logdir=logdir)
    for shared in ({}, {"PYTHONPATH": env["PYTHONPATH"]}):
        for command in COMMANDS:
            assert wrap_docker_command(command, cfg, shared) == \
                jax_record.wrap_docker_command(command, jcfg, shared)
    assert wrap_docker_command("python t.py", cfg, env) == "python t.py"


def _stubs(tmp_path, perf_body):
    """PATH stubs: ``docker run`` runs the workload here and publishes a
    container id and pid; ``docker inspect`` serves the pid back; ``perf``
    writes its argv (``perf_body`` decides whether it lives)."""
    stubs = tmp_path / "stubs"
    stubs.mkdir()
    pidfile = tmp_path / "container.pid"
    perf_argv = tmp_path / "perf_argv.txt"
    seen_env = tmp_path / "docker_args.txt"
    # /bin/sh, not python: they must write their evidence before the
    # watcher's 0.5 s liveness poll, even on a loaded machine
    (stubs / "docker").write_text(textwrap.dedent(f"""\
        #!/bin/sh
        if [ "$1" = inspect ]; then cat {pidfile}; exit 0; fi
        [ "$1" = run ] || exit 64
        shift
        printf '%s\\n' "$@" > {seen_env}
        while [ $# -gt 0 ]; do
          case "$1" in
            --cidfile) printf c0ffee1234beef > "$2"; shift 2;;
            img) shift; break;;
            *) shift;;
          esac
        done
        echo $$ > {pidfile}
        exec "$@"
        """))
    (stubs / "perf").write_text("#!/bin/sh\n" + perf_body.format(
        argv=perf_argv))
    for s in ("docker", "perf"):
        os.chmod(stubs / s, os.stat(stubs / s).st_mode | stat.S_IEXEC)
    return stubs, pidfile, perf_argv, seen_env


def test_docker_record_scopes_perf_to_the_container(logdir, tmp_path,
                                                    monkeypatch):
    stubs, pidfile, perf_argv, seen = _stubs(
        tmp_path, "printf '%s\\n' \"$@\" > {argv}\nexec sleep 300\n")
    monkeypatch.setenv("PATH", f"{stubs}:{os.environ['PATH']}")
    monkeypatch.setattr(perfmod, "_read_int", lambda path: -1)
    cfg = SofaConfig(logdir=logdir, enable_kineto=False)
    assert sofa_record("docker run img sleep 2", cfg) == 0
    assert perf_argv.is_file(), "the watcher never launched the scoped perf"
    argv = perf_argv.read_text().splitlines()
    # scoped to the container (cgroup filter or pid), never wrapping the
    # docker CLI
    assert ("-G" in argv and "-a" in argv) or "-p" in argv
    assert "docker" not in argv and "--" not in argv
    assert cfg.path("perf.data") in argv
    if "-p" in argv:
        assert argv[argv.index("-p") + 1] == pidfile.read_text().strip()
    with open(cfg.path("docker.cid")) as f:
        assert f.read().startswith("c0ffee1234")
    # the container got the logdir and the injection's environment
    args = seen.read_text().splitlines()
    absdir = os.path.abspath(logdir)
    assert f"{absdir}:{absdir}" in args
    assert any(a.startswith("SOFA_TORCH_KINETO_OPTS=") for a in args)
    assert any(a.startswith("PYTHONPATH=") and
               os.path.abspath(cfg.inject_dir) in a for a in args)


def test_docker_scope_falls_back_to_the_pid_when_cgroup_perf_dies(
        tmp_path, monkeypatch):
    stubs, pidfile, perf_argv, _ = _stubs(
        tmp_path, "printf '%s\\n' \"$@\" >> {argv}\n"
        "for a in \"$@\"; do [ \"$a\" = \"-G\" ] && exit 1; done\n"
        "exec sleep 300\n")
    monkeypatch.setenv("PATH", f"{stubs}:{os.environ['PATH']}")
    monkeypatch.setattr(perfmod, "_read_int", lambda path: -1)
    # this host runs in the root cgroup; pin a container-like one, so that
    # the -G attempt happens
    monkeypatch.setattr(record_mod, "_perf_cgroup_rel",
                        lambda text: "docker/stubcid")
    logdir = str(tmp_path / "log") + "/"
    os.makedirs(logdir)
    cfg = SofaConfig(logdir=logdir, enable_kineto=False)
    assert sofa_record("docker run img sleep 2", cfg) == 0
    lines = perf_argv.read_text().splitlines()
    assert "-G" in lines and "-p" in lines
    assert lines.index("-G") < lines.index("-p")
    assert lines[lines.index("-G") + 1] == "docker/stubcid"
    assert lines[lines.index("-p") + 1] == pidfile.read_text().strip()
