"""The hardware-fuzz harness itself (scripts/fuzz.py), run at mini
scale on the CI backend — guards the differential plumbing (oracle
comparison, unsat planting, batched/sharded drivers) so the real soak
never breaks on harness bugs."""

import importlib.util
import sys
from pathlib import Path

_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "fuzz.py"
_spec = importlib.util.spec_from_file_location("gf2bv_fuzz", _SCRIPT)
fuzz = importlib.util.module_from_spec(_spec)
sys.modules.setdefault("gf2bv_fuzz", fuzz)
_spec.loader.exec_module(fuzz)


def test_fuzz_main_mini():
    fuzz.main(n=3, cols=300, backend="jax", seed=0xA11CE)


def test_fuzz_batched_mini():
    fuzz.fuzz_batched(n=4, batch=2, cols=300, seed=0xB0B)


def test_fuzz_sharded_mini():
    fuzz.fuzz_sharded(n=2, cols=300, seed=0xCAFE)


def test_fuzz_lazy_mini():
    fuzz.fuzz_lazy(n=4, seed=0xDEED)


def test_fuzz_quad_mini():
    fuzz.fuzz_quad(n=2, seed=0xFEED)


def test_fuzz_capture_mini():
    fuzz.fuzz_capture(n=2, per_template=2, seed=0xCA11)


def test_fuzz_multi_rhs_mini():
    fuzz.fuzz_multi_rhs(n=1, seed=0x3B51)


def test_fuzz_native_route_mini():
    fuzz.fuzz_native_route(n=4, seed=0x4A7E)


def test_fuzz_incremental_mini():
    fuzz.fuzz_incremental(n=2, seed=0x17C4)


def test_fuzz_engines_mini():
    fuzz.fuzz_engines(n=1, seed=0xE491)
