"""Persistent XLA compilation cache setup.

First compilation of the fused sampling loop takes tens of seconds to
minutes; the persistent cache makes later process launches start hot.
Enabled by the CLI, the server and the bench.

Where it lives (:func:`cache_dir`): ``JAX_COMPILATION_CACHE_DIR`` when that
is set (JAX reads the variable itself, and no other path is set in code);
otherwise one fixed directory inside the checkout, ``<repo>/.jax_cache``,
which ``.gitignore`` lists.  A fixed path matters: the path is part of
what a later process must find again.

``host_subdir=True`` (the CPU test suite) adds a subdirectory keyed by a
fingerprint of the host CPU's feature flags to the default path: XLA:CPU
AOT results do not key on the target machine features, so an entry written
on one host can SIGILL when loaded on another.
"""
import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")
ENV = "JAX_COMPILATION_CACHE_DIR"


def _host_cpu_tag():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    import hashlib
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha1(flags.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform
    return platform.machine() or "unknown"


def cache_dir(host_subdir: bool = False) -> str:
    """The directory the cache uses (see the module docstring)."""
    env = os.environ.get(ENV)
    if env:
        return env
    if host_subdir:
        return os.path.join(DEFAULT_DIR, "cpu-" + _host_cpu_tag())
    return DEFAULT_DIR


def enable(host_subdir: bool = False) -> None:
    """Turn the persistent cache on; a failure leaves it off (the cache is
    an optimization, never fatal)."""
    try:
        import jax
        if not os.environ.get(ENV):
            path = cache_dir(host_subdir)
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except Exception:  # noqa: BLE001
        pass
