"""sweep.row_fill_pct: live over padded (spec, rate) rows of the
window's groups, from the `s_live`, `s_pad`, `r_live`, `r_pad`
attributes of the program's `sweep.group` spans."""


def read(rec):
    live = pad = 0
    for sp in rec["spans"]:
        if sp.name == "sweep.group":
            a = sp.args
            live += int(a["s_live"]) * int(a["r_live"])
            pad += int(a["s_pad"]) * int(a["r_pad"])
    return 100.0 * live / pad if pad else None
