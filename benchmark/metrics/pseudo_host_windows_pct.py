"""pseudo_host_windows_pct: the share of phase 4's windows that went to the
host (over L_CAP, over A_CAP anchors, or otherwise flagged by the kernels),
100 x host / (card + host), from the program's counters
`pseudo.card_windows` and `pseudo.host_windows` over the window.  Nothing
where the program has no such counters or had no window."""


def read(run):
    card = run.eng_times.get("pseudo.card_windows")
    host = run.eng_times.get("pseudo.host_windows")
    if card is None or host is None or card + host <= 0:
        return None
    return 100.0 * host / (card + host)
