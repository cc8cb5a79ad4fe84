"""Host ms a scan in the engine's own work around its prep and its
device pipeline (process_scan_fast less the prep's `ms["prep"]` and
less the pipeline's `process_chunks` call: the scan's int16 copy, the
labels, the heatmap's scale to float32), over the window's scans: the
driver's host clock. Nothing to read in a window without the engine."""


def read(ctx):
    s = ctx["window"].get("engine_s")
    return 1e3 * sum(s) / len(s) if s else None
