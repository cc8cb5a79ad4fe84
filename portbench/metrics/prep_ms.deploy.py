"""Host ms a scan in the engine's C++ prep (`prep_scan_chunks`, in line
in process_scan_fast), over the window's scans: the engine's own host
clock around the call (its `ms["prep"]`). Nothing to read in a window
without the engine's prep."""


def read(ctx):
    s = ctx["window"].get("prep_s")
    return 1e3 * sum(s) / len(s) if s else None
