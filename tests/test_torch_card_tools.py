"""The card tools load on the CPU and share one roofline: ``chip_smoke.py``
(the card's correctness check) and ``scripts/bench_kernels.py`` (the
kernels timed alone) import, every global name their functions use
resolves, and the kernel timer's bounds are ``cmbbench/work.py``'s own
functions and peaks. Nothing here needs a card or imports JAX."""
import builtins
import importlib.util
import symtable
from pathlib import Path

from cmbbench import work

REPO = Path(__file__).resolve().parent.parent
TOOLS = {"chip_smoke": REPO / "chip_smoke.py",
         "bench_kernels": REPO / "scripts" / "bench_kernels.py"}


def _load(name):
    """The tool's module, loaded by path without running its main()."""
    spec = importlib.util.spec_from_file_location(f"_card_tool_{name}",
                                                  TOOLS[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _unresolved(mod, path):
    """Global names read inside the module's functions that neither the
    module nor the builtins define."""
    missing = set()

    def walk(tab):
        for sym in tab.get_symbols():
            name = sym.get_name()
            if (tab.get_type() != "module" and sym.is_global()
                    and sym.is_referenced() and not hasattr(mod, name)
                    and not hasattr(builtins, name) and name != "__file__"):
                missing.add(f"{tab.get_name()}: {name}")
        for child in tab.get_children():
            walk(child)

    walk(symtable.symtable(path.read_text(), str(path), "exec"))
    return sorted(missing)


def test_card_tools_load():
    for name, path in TOOLS.items():
        mod = _load(name)
        assert callable(mod.main), name
        assert _unresolved(mod, path) == [], name


def test_card_tools_share_one_roofline():
    bench = _load("bench_kernels")
    assert bench.bound is work.bound
    assert bench.ops_ms is work.ops_ms
    assert bench.HBM_BYTES_PER_S is work.HBM_BYTES_PER_S
    smoke = _load("chip_smoke")
    for name in ("cuda_ms", "ops_ms", "bound", "HBM_BYTES_PER_S",
                 "profile_steps", "host_ops"):
        assert not hasattr(smoke, name), name
