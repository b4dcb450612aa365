"""Engine: prompt tokens served from the prefix cache, over all prompt
tokens (``Result.cached_tokens`` / ``Result.prompt_tokens``) of the
requests due in the window that finished; %."""


def read(rec):
    done = [r.result for r in rec.due_in_window() if r.result is not None]
    total = sum(r.prompt_tokens for r in done)
    return 100.0 * sum(r.cached_tokens for r in done) / total if total else None
