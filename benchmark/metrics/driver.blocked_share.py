"""Share of the window that run_eval_pc's main thread spent blocked on loading and on
flushing its writes: the sum of its returned clock's load_s and write_flush_s over every
scene, over the window's seconds (%)."""


def read(run):
    blocked = run.counters.get("blocked_s")
    if blocked is None or not run.window_s:
        return None
    return 100.0 * blocked / run.window_s
