"""``train_tokens_per_s``: tokens of every step completed in the window
over the window's seconds (host clock, each step ending in the loop's
read of its metrics)."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    return rec["window_tokens"] / rec["window_s"]
