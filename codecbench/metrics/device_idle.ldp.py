"""The share of the traced encode (the low-delay cell only encodes) in
which no kernel runs on the card."""

from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx, "encode")
