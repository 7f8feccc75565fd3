"""Serve a policy over HTTP with continuous batching: the port's policy
server process (the counterpart of the JAX package's
`examples/serve_policy.py`).

    # serve an export, hot-reloading new checkpoints of a training run
    python -m trlx_tpu_torch.inference.serve_policy \
        '{"checkpoint": "ckpts/hf_model", "watch_dir": "ckpts", "port": 8600}'

    # smoke-serve a random tiny model on the CPU
    python -m trlx_tpu_torch.inference.serve_policy \
        '{"checkpoint": "random:gpt2-tiny", "device": "cpu"}'

    # a local rollout fleet: N replicas in one process on consecutive
    # ports (port 0: each OS-assigned), and the train.rollout_* snippet
    # for the trainer that generates through them
    python -m trlx_tpu_torch.inference.serve_policy \
        '{"checkpoint": "random:gpt2-tiny", "replicas": 3}'

    # the same fleet under lifecycle supervision (respawns, quarantine,
    # warm spares, rolling sync of new checkpoints in watch_dir), with
    # the fleet's Prometheus metrics on metrics_port
    python -m trlx_tpu_torch.inference.serve_policy \
        '{"checkpoint": "random:gpt2-tiny", "replicas": 3, "supervised": true,
          "spares": 1, "watch_dir": "ckpts", "metrics_port": 8700}'

    # many tenants' LoRA adapters over one trunk: each subdirectory of
    # adapter_dir is a checkpoint of a LoRA run (its name is the
    # request's adapter_id); the trunk must be LoRA-enabled
    python -m trlx_tpu_torch.inference.serve_policy \
        '{"checkpoint": "random:gpt2-tiny", "adapter_dir": "adapters",
          "model.peft_config": {"peft_type": "LORA", "r": 8}}'

`checkpoint` is a `save_pretrained` directory or `random:<preset>`;
`device` is where the policy runs (cuda unless given: no replica falls
back to the CPU by itself). Any other dotted TRLConfig key overrides the
config; the `inference.*` section holds the serving knobs. An
`adapter_dir` implies multi-tenant serving (`inference.multi_tenant`,
which the hparams may still set explicitly).
"""

import json
import sys


def main(hparams=None):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.data.default_configs import default_sft_config

    hparams = dict(hparams if hparams is not None else (json.loads(sys.argv[1]) if len(sys.argv) > 1 else {}))
    checkpoint = hparams.pop("checkpoint")
    resume = hparams.pop("resume", None)
    tokenizer = hparams.pop("tokenizer", "byte")
    port = int(hparams.pop("port", 8600))
    watch_dir = hparams.pop("watch_dir", None)
    background = hparams.pop("background", False)  # tests set this
    replicas = int(hparams.pop("replicas", 1))
    supervised = bool(hparams.pop("supervised", False))
    spares = int(hparams.pop("spares", 0))
    metrics_port = hparams.pop("metrics_port", None)
    supervisor_kwargs = dict(hparams.pop("supervisor_kwargs", None) or {})
    device = hparams.pop("device", "cuda")
    adapter_dir = hparams.pop("adapter_dir", None)

    config = default_sft_config().evolve(
        model=dict(model_path=checkpoint),
        tokenizer=dict(tokenizer_path=tokenizer),
        train=dict(total_steps=0, tracker=None),
        # under supervision the replicas must not watch the directory
        # themselves: the supervisor owns reloads (rolling, one at a time)
        inference=dict(
            port=port,
            watch_dir=None if supervised else watch_dir,
            # an adapter_dir implies multi-tenant serving (the hparams can
            # still set inference.multi_tenant explicitly)
            **({"adapter_dir": adapter_dir, "multi_tenant": True} if adapter_dir else {}),
        ),
    )
    if hparams:
        config = TRLConfig.update(config, hparams)

    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    trainer = SFTTrainer(config, device=device)
    if resume:
        trainer.load(resume)
    print(f"serve_policy: policy on {trainer.device}", flush=True)

    if supervised:
        # thread replicas under a FleetSupervisor: a self-healing fleet in
        # one process; the printed snippet points a trainer at its active
        # replicas (a trainer that supervises its own fleet sets
        # train.rollout_fleet_supervised instead)
        from trlx_tpu_torch.inference.supervisor import FleetSupervisor, ThreadReplica

        def factory(seat_index):
            return ThreadReplica(lambda: trainer.serve(port=0, background=True))

        supervisor = FleetSupervisor(
            factory, num_replicas=replicas, spares=spares, watch_dir=watch_dir,
            metrics_port=None if metrics_port is None else int(metrics_port), **supervisor_kwargs,
        ).start()
        supervisor.wait_ready(timeout_s=supervisor.start_timeout_s)
        urls = [s.url for s in supervisor.seats if s.role == "active" and s.url]
        print(f"Supervising {replicas} replicas (+{spares} spares): " + ", ".join(urls), flush=True)
        if metrics_port is not None:
            print(f"Fleet metrics: http://127.0.0.1:{supervisor.metrics_port}/metrics", flush=True)
        print("Trainer config for these replicas (TRLConfig.evolve / hparams):")
        print(json.dumps({"train": {"rollout_backend": "fleet", "rollout_fleet_urls": urls}}, indent=2), flush=True)
        if background:
            return supervisor
        try:
            while True:
                supervisor._thread.join(3600)
        except KeyboardInterrupt:
            supervisor.stop()
        return supervisor

    if replicas > 1:
        # one process, N independent replicas (an engine and a scheduler
        # each) on consecutive ports: the smallest real fleet
        servers = [trainer.serve(port=port + i if port else 0, background=True) for i in range(replicas)]
        urls = [s.url for s in servers]
        print(f"Serving {replicas} replicas: {', '.join(urls)}")
        print("Trainer config for these replicas (TRLConfig.evolve / hparams):")
        print(json.dumps({"train": {"rollout_backend": "fleet", "rollout_fleet_urls": urls,
                                    "rollout_max_staleness_steps": 1}}, indent=2), flush=True)
        if background:
            return servers
        try:
            while True:
                servers[0]._thread.join(3600)
        except KeyboardInterrupt:
            for s in servers:
                s.shutdown()
        return servers

    return trainer.serve(background=background)


if __name__ == "__main__":
    main()
