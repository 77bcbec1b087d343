"""Two-process CLI loopback through the port: server and client pipelines
as separate ``python -m nnstreamer_tpu_torch.cli --device cpu`` processes
on localhost, the cases of ``tests/test_cli_loopback.py``, held to the
JAX package's answers (exact: uint8 pixels and greedy token ids). Beside
them a port server answering a reference client process.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = [sys.executable, "-m", "nnstreamer_tpu_torch.cli", "--device", "cpu"]
REF_CLI = [sys.executable, "-m", "nnstreamer_tpu.cli"]


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _listening(port: int) -> bool:
    """Whether a TCP socket listens on ``port`` (read from the kernel's
    socket table, /proc/net/tcp: state 0A is LISTEN)."""
    with open("/proc/net/tcp") as f:
        next(f)
        for line in f:
            local, state = line.split()[1], line.split()[3]
            if state == "0A" and int(local.split(":")[1], 16) == port:
                return True
    return False


def _wait_port(port: int, proc, timeout: float = 30.0) -> None:
    """Wait until ``proc`` listens on ``port``, without connecting: a probe
    connection would be accepted as a peer (an edgesink's wait-connection
    would publish its first frame to it)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate()[1][-600:]
        if _listening(port):
            return
        time.sleep(0.05)
    raise TimeoutError(f"server port {port} never opened")


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _serve(desc: str):
    return subprocess.Popen(PORT_CLI + [desc, "--timeout", "60", "-q"], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _scaler_server(port: int):
    return _serve(f"tensor_query_serversrc port={port} id=cli1 ! "
                  'tensor_filter framework=scaler custom="factor:2.0" '
                  "input=3:4:4:1 inputtype=uint8 ! tensor_query_serversink id=cli1")


def _client_desc(port: int, out) -> str:
    return ("videotestsrc pattern=counter num-frames=3 width=4 height=4 ! "
            f"tensor_converter ! tensor_query_client dest-port={port} timeout=30 ! "
            f"filesink location={out}")


def _check_doubled(out) -> None:
    got = np.frombuffer(out.read_bytes(), np.uint8).reshape(3, -1)
    for i in range(3):  # counter pattern: frame i is i everywhere, doubled
        assert (got[i] == np.uint8(2 * i)).all()


def test_query_offload_two_processes(tmp_path):
    port = _free_port()
    server = _scaler_server(port)
    try:
        _wait_port(port, server)
        out = tmp_path / "reply.raw"
        client = subprocess.run(PORT_CLI + [_client_desc(port, out), "-q"], env=_env(),
                                capture_output=True, text=True, timeout=120)
        assert client.returncode == 0, client.stderr[-600:]
        _check_doubled(out)
    finally:
        _stop(server)


def test_reference_client_process_against_port_server(tmp_path):
    port = _free_port()
    server = _scaler_server(port)
    try:
        _wait_port(port, server)
        out = tmp_path / "reply.raw"
        client = subprocess.run(REF_CLI + [_client_desc(port, out), "-q"], env=_env(),
                                capture_output=True, text=True, timeout=120)
        assert client.returncode == 0, client.stderr[-600:]
        _check_doubled(out)
    finally:
        _stop(server)


def test_edge_pubsub_two_processes(tmp_path):
    port = _free_port()
    out = tmp_path / "sub.raw"
    pub = subprocess.Popen(
        PORT_CLI + ["videotestsrc pattern=counter num-frames=2 width=4 height=4 ! "
                    f"tensor_converter ! edgesink port={port} "
                    "wait-connection=true connection-timeout=60", "-q"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _wait_port(port, pub)
        sub = subprocess.run(PORT_CLI + [f"edgesrc dest-port={port} ! filesink location={out}",
                                         "--timeout", "60", "-q"],
                             env=_env(), capture_output=True, text=True, timeout=120)
        assert sub.returncode == 0, sub.stderr[-600:]
        assert pub.wait(timeout=30) == 0
        data = np.frombuffer(out.read_bytes(), np.uint8)
        assert data.size == 2 * 4 * 4 * 3
        assert (data[:48] == 0).all() and (data[48:] == 1).all()
    finally:
        _stop(pub)


def test_llm_query_offload_two_processes(tmp_path):
    """A client process offloads a token prompt; the server process
    generates through the continuous batcher (the reference's seed-5
    weights, exported) and routes the reply back: equal to the JAX
    package's solo generation."""
    from nnstreamer_tpu.models import decode as dec
    from nnstreamer_tpu.models import transformer as tfm

    params = tfm.init_params(jax.random.PRNGKey(5), vocab=211, d_model=32, n_heads=2,
                             n_layers=2)
    npz = tmp_path / "lm.npz"
    np.savez(npz, **{f"p{i}": np.asarray(x)
                     for i, x in enumerate(jax.tree_util.tree_leaves(params))})
    port = _free_port()
    model = f"vocab:211,d_model:32,n_heads:2,n_layers:2,params:{npz}"
    server = _serve(f"tensor_query_serversrc port={port} id=lq1 ! "
                    f'tensor_llm_serversink id=ls1 custom="{model}" '
                    "max-new-tokens=5 n-slots=2 max-len=32 prompt-len=8 "
                    "tensor_llm_serversrc id=ls1 ! tensor_query_serversink id=lq1")
    try:
        _wait_port(port, server)
        out = tmp_path / "tokens.raw"
        client = subprocess.run(
            PORT_CLI + ["tensorsrc dimensions=6:1 types=int32 num-frames=1 pattern=ones ! "
                        f"tensor_query_client dest-port={port} timeout=60 ! "
                        f"filesink location={out}", "-q"],
            env=_env(), capture_output=True, text=True, timeout=180)
        assert client.returncode == 0, client.stderr[-600:]
        got = np.frombuffer(out.read_bytes(), np.int32)
        want = np.asarray(dec.generate(params, jnp.ones((1, 6), jnp.int32), 2, 5))[0]
        np.testing.assert_array_equal(got, want)
    finally:
        _stop(server)
