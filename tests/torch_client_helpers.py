"""Helpers that the port's client test files share."""


def reap_detached(client, timeout=10.0):
    """Stop the tasks `client` detached from and wait for their runners.
    shutdown(kill_tasks=False) leaves them running, as a crashed client
    would; left alone, each runner pushes its last update when its task
    ends, into a server long shut down, as an ERROR under whatever test
    the process runs then."""
    runners = list(client.runners.values())
    for runner in runners:
        runner.stop()
    for runner in runners:
        for tr in runner.task_runners:
            if tr._thread is not None:
                tr._thread.join(timeout)
