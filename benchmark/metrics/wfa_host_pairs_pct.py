"""wfa_host_pairs_pct: the share of phase 5's WFA pairs that the host
aligned, 100 x host / (card + host), from the program's counters
`wfa.card_pairs` and `wfa.host_pairs` over the window.  Nothing where the
program has no such counters or aligned no pair."""


def read(run):
    card = run.eng_times.get("wfa.card_pairs")
    host = run.eng_times.get("wfa.host_pairs")
    if card is None or host is None or card + host <= 0:
        return None
    return 100.0 * host / (card + host)
