"""`output_tokens_per_s`: the tokens generated by the window's calls
(batch x n_new each, every step computed), over the time from the first
call's start to the last call's end."""


def read(run):
    calls = [r for r in run.calls if "n_new" in r]
    if not calls:
        return None
    tokens = sum(r["batch"] * r["n_new"] for r in calls)
    return tokens / (calls[-1]["t1"] - calls[0]["t0"])
