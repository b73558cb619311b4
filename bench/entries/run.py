"""Requests one at a time through ``Partitioner.run``: each call of
``call(i)`` sends the window's i-th request and returns it finished."""


def make(graph, config: dict, traffic: dict, seed: int, device):
    """``call(i) -> [(params, result)]`` for the configuration's requests
    on ``graph`` (the program's ``Graph``): k, epsilon, preset and kernel
    from the configuration, the mix's ``request`` knobs, and request seeds
    cycling over ``request_seed_cycle`` values from the run's seed."""
    from repro_torch.api import Partitioner, PartitionRequest
    part = Partitioner(device=device)
    knobs = traffic["request"]
    cycle = int(traffic["request_seed_cycle"])

    def call(i):
        params = dict(k=int(config["k"]), epsilon=float(config["epsilon"]),
                      preset=config["preset"], kernel=config["kernel"],
                      seed=(seed % 2**31 + i % cycle) % 2**31, **knobs)
        return [(params, part.run(PartitionRequest(graph=graph, **params)))]
    return call
