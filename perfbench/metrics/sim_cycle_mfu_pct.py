"""sim_cycle_mfu_pct: the whole simulated cycle's share of the chip's
peak.  The least bytes the window's cycles had to move (each live row's
router state at its spec's own shape, read once and written once;
`perfbench.roofline.cycle_state_bytes`) over 3.35 TB/s, over the
window's wall time."""
from perfbench import roofline as RL


def read(rec):
    moved = sum(rec["n_rates"] * rec["cycles"]
                * RL.cycle_state_bytes(n, p, c, d, rec["n_vcs"],
                                       rec["buf_depth"])
                for g in rec["window"] for n, p, c, d in g["dims"])
    return 100.0 * moved / RL.PEAK_BYTES_PER_S / rec["window_s"]
