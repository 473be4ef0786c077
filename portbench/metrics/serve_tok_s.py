"""serve_tok_s: every output token emitted in the window (first tokens
and decoded ones) over the window's seconds."""


def read(record):
    its = [i for i in record["iterations"] if i["phase"] == "window"]
    tokens = sum(len(i["prefills"]) + i["active"] for i in its)
    secs = record["window"]["seconds"]
    record.setdefault("bases", []).append(
        f"serve_tok_s: {tokens} tokens over {secs!r} s, {len(its)} iterations")
    return tokens / secs
