"""Engine: real prompt tokens prefilled over the admission grid's rows
times 32 over the window's ``LM.prefill_paged`` calls (the engine's
``prefill_tokens`` and ``prefill_dispatches`` counters); %."""


def read(rec):
    calls = rec.counter("prefill_dispatches")
    if not calls:
        return None
    return 100.0 * rec.counter("prefill_tokens") / (calls * rec.node["max_active"] * 32)
