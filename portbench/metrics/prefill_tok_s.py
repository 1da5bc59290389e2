"""prefill_tok_s (tokens/s): prompt tokens prefilled in the window over the
window's seconds; a prefill step that straddles the window's close counts in
proportion. Host clock."""


def read(run):
    return run.rate("prefill", "real_tokens")
