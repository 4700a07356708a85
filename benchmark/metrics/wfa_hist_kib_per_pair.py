"""wfa_hist_kib_per_pair: the card's WFA history scratch a pair, in KiB,
wfa.hist_bytes / wfa.card_pairs / 1024 over the window, from the program's
counters (the bytes its phase-5 launches allocated for history, and the
pairs it sent to the card).  Nothing where the program has no
`wfa.hist_bytes` counter or sent no pair to the card."""


def read(run):
    hist = run.eng_times.get("wfa.hist_bytes")
    card = run.eng_times.get("wfa.card_pairs")
    if hist is None or not card:
        return None
    return hist / card / 1024
