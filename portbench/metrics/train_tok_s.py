"""train_tok_s: the tokens of every training step completed in the
window over the window's seconds."""


def read(record):
    steps, secs = len(record["steps"]), record["window"]["seconds"]
    record.setdefault("bases", []).append(
        f"train_tok_s: {steps} steps of {record['tokens_per_step']} tokens over {secs!r} s")
    return steps * record["tokens_per_step"] / secs
