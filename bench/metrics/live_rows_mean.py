"""Live rows a decode step over the window: tokens generated (live rows x
steps of each span) over decode steps, the server's counters. At a fixed
arrival rate it is the rate times the time a request stays (Little's
law), so a faster step lowers it."""


def read(ctx):
    c = ctx.get("counters")
    if not c or not c.get("decode_steps"):
        return None
    return c["gen_tokens"] / c["decode_steps"]
