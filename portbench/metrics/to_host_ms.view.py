"""Host milliseconds per served frame in the program's `frame.to_host`
span less its `.sync` child: the frame's copy to the host once the
device is done, from the window a traced run keeps with the program's
spans on (spans.traced)."""


def read(rec):
    return (rec.get("spans") or {}).get("metrics", {}).get("to_host_ms.view")
