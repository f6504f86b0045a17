"""The host's time in ``make_eval_step``'s call, from the call to its
return before any synchronisation, mean over the window's requests, in ms:
the launch pace of a request."""


def read(rec):
    xs = rec.get("host_dispatch_ms")
    if rec.get("loop") != "eval" or not xs:
        return None
    return sum(xs) / len(xs)
