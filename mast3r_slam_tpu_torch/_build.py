"""Build and load the package's CUDA kernels and its host C++ libraries.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface (it
may include the shared headers ``csrc/*.cuh``). It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/``
(git-ignored), named by a hash of the sources, and loaded with
``ctypes``. Nothing is compiled or loaded when this module is imported: the
first call that needs a kernel builds it, and :func:`build_all` builds
several at once in parallel ``nvcc`` processes. The wrappers also share
their launch counter (with the recording of a CUDA graph capture's
launches, which each replay of the graph counts, and the launches a step
of loops whose exit the device decides), SM count and
input-alignment helpers from here. :func:`build_host` compiles one of
``native/*.cpp`` (the global TSDF's voxel hash, the JPEG and video
decoders) with ``g++`` the same way.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc (the CUDA compiler) was not found on PATH or in "
        "/usr/local/cuda/bin: the CUDA kernels cannot be built here")


def library_path(name: str) -> Path:
    """The library of kernel ``name``, keyed by its source and the shared
    headers (``csrc/*.cuh``) it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names, log=None) -> dict[str, Path]:
    """Compile every kernel in ``names`` that is not built yet, one ``nvcc``
    process each, all started together. ``log`` (a callable) receives the
    compiler's output (register and shared-memory use). Returns the
    library paths."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
        procs[n] = (tmp, subprocess.Popen(
            _nvcc_cmd(nvcc, n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if log is not None and out:
            log(f"[nvcc {n}]\n{out.rstrip()}")
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def build_host(src: Path, build_dir: Path, what: str,
               flags: tuple = (), deps: tuple = ()) -> Path:
    """Compile host C++ source ``src`` with ``g++ -O2`` and ``flags`` (no
    ``-march``: the library is never committed or carried between
    machines) into ``build_dir``, named by a hash of the source, the files
    it includes (``deps``) and the flags, unless it is built already.
    Raises, naming ``what``, when it cannot be built."""
    h = hashlib.sha256(src.read_bytes())
    for dep in deps:
        h.update(Path(dep).read_bytes())
    h.update(" ".join(flags).encode())
    digest = h.hexdigest()[:16]
    so = build_dir / f"lib{src.stem}-{digest}.so"
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    # a name of its own per process: test workers may build at once
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", *flags, "-shared", "-fPIC", str(src), "-o",
           str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        msg = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(f"building the {what} failed: {msg}")
    tmp.replace(so)
    return so


def load(name: str, entries=None) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    ``entries`` maps C entry names to their ctypes argument types; each is
    bound (returning a C ``int``) the first time a caller names it, so
    several wrapper modules can bind their own entries of one library."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        for entry, argtypes in (entries or {}).items():
            fn = getattr(lib, entry)
            if fn.argtypes is None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise when kernel ``name``'s launcher returned a non-zero
    ``cudaError_t``; the message is CUDA's own."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")


_capture = threading.local()

# Held by a thread while it captures a CUDA graph (ops/graphs.py: the
# tracker's, the backend's solve and decode + match). A device-wide sync
# (torch.cuda.synchronize) in another thread during a capture fails and
# invalidates the capture: a thread that may sync the whole device while
# another captures holds this lock around the sync (utils/tictoc.py::sync
# and LaunchCounter.launches do).
capture_lock = threading.RLock()


class LaunchCounter:
    """Launch counter of one kernel: its wrapper calls :meth:`add` once per
    launch of the kernel, and nothing else touches it but a reset of
    ``launches``, the replays of a CUDA graph (:class:`LaunchRecording`)
    and the loops whose exit the device decides (``ops/device_loop.py``),
    whose steps are counted on the device (:meth:`add_steps`): one 0-dim
    accumulator a device, read when ``launches`` is read or set, which
    waits for the devices those loops ran on. Read the counts where no
    kernel is running. The add holds a lock: the CLI's backend thread
    launches kernels beside the frontend."""

    def __init__(self):
        self._launches = 0
        self._acc = {}           # device -> int64 accumulator of launches
        self._seen = {}          # device -> its value already counted
        self._lock = threading.Lock()

    def _fold(self):
        """Add what the device accumulators gained since the last read."""
        if not self._acc:
            return
        import torch

        with capture_lock:
            for dev in list(self._acc):
                torch.cuda.synchronize(dev)
        with self._lock:
            for dev, acc in self._acc.items():
                total = int(acc)
                self._launches += total - self._seen[dev]
                self._seen[dev] = total

    @property
    def launches(self):
        self._fold()
        return self._launches

    @launches.setter
    def launches(self, value):
        self._fold()
        with self._lock:
            self._launches = value

    def add(self, n=1):
        recording = getattr(_capture, "recording", None)
        if recording is not None:
            # this thread is capturing a CUDA graph or recording a loop
            # step: nothing is counted now (see LaunchRecording)
            recording.counts[self] = recording.counts.get(self, 0) + n
            return
        with self._lock:
            self._launches += n

    def add_steps(self, count, n):
        """Count ``n`` launches for each step of a loop that ran on the
        device: ``count`` is a device int that holds its steps once the
        work queued on the current stream has run; the accumulator adds it
        there, behind that work."""
        import torch

        dev = count.device
        with self._lock:
            acc = self._acc.get(dev)
            if acc is None:
                acc = torch.zeros((), dtype=torch.int64, device=dev)
                self._acc[dev], self._seen[dev] = acc, 0
        acc.add_(count, alpha=n)


class LaunchRecording:
    """Within the block, the calling thread's :meth:`LaunchCounter.add`
    calls are recorded in ``counts`` (counter → launches) instead of
    counted: a CUDA graph's capture launches nothing. A loop captured in
    the block (:func:`loop_step`) is recorded in ``loops`` with its step
    counter and its launches a step. :meth:`replayed` adds the recorded
    counts once, for one replay, and counts each loop's launches a step
    times the steps the node ran, on the device (a replay reads nothing on
    the host). Other threads count as usual."""

    def __init__(self):
        self.counts: dict[LaunchCounter, int] = {}
        self.loops: list[tuple] = []     # (device int of steps, counts)

    def __enter__(self):
        if getattr(_capture, "recording", None) is not None:
            raise RuntimeError("a launch recording is already open on this "
                               "thread")
        _capture.recording = self
        return self

    def __exit__(self, *exc):
        _capture.recording = None
        return False

    def replayed(self):
        for counter, n in self.counts.items():
            counter.add(n)
        for count, per_step in self.loops:
            for counter, n in per_step.items():
                counter.add_steps(count, n)


@contextlib.contextmanager
def loop_step(count):
    """Within the block (the capture of a loop's body inside a graph's
    :class:`LaunchRecording`), the calling thread's launches are one step
    of a loop whose device int ``count`` holds, once the loop has run, the
    steps it ran (``ops/device_loop.py``'s conditional node): the loop
    joins the recording. Loops do not nest."""
    outer = getattr(_capture, "recording", None)
    if outer is None:
        raise RuntimeError("a loop step recorded outside a graph's capture")
    step = LaunchRecording()
    _capture.recording = step
    try:
        yield
    finally:
        _capture.recording = outer
    if step.loops:
        raise RuntimeError("a loop inside a loop step")
    outer.loops.append((count, step.counts))


_sms: dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of CUDA ``device`` (cached): the kernels'
    grid planners spread their blocks over them."""
    import torch

    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def aligned(t):
    """``t`` itself, or a copy when its data pointer is not 16-byte aligned
    (a view with an odd offset): the kernels read 16-byte vectors. ``None``
    passes through."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()
