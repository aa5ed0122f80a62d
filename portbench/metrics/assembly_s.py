"""Wall seconds a job: the window from its start to the end of its last job,
over the jobs it ran."""


def read(ctx):
    return ctx.window_s / ctx.jobs
