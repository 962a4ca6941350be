"""Host milliseconds per served frame spent in the program's `*.sync`
spans, where the host waits for the device, from the window a traced run keeps with the program's
spans on (spans.traced)."""


def read(rec):
    return (rec.get("spans") or {}).get("metrics", {}).get("sync_wait_ms.view")
