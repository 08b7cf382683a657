"""host_launches_per_step.train (calls/step; layer: K-step call): the host's
``cudaLaunchKernel`` and ``cudaGraphLaunch`` runtime calls (and their
driver-API and versioned forms) per step of the traced call."""

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
            "cuGraphLaunch")


def read(s: dict):
    n = sum(c for name, c in s["runtime"].items()
            if name.startswith(LAUNCHES))
    return n / s["steps"] if s["device_ops"] else None
