"""Tokens generated by the window's steps over the time they took, from
the window's start to the return of its last step; host clock.  A step
is whole: the last one may be an admission of seconds that ends past the
window's nominal end, and cutting the count there would hide any change
in speed smaller than that step."""
from harness import readers


def read(rec):
    return readers.tokens_in_window(rec) / (rec.t_exit - rec.t0)
