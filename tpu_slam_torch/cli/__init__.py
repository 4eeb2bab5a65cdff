"""Command-line runners of the port (the reference's ``tpu_slam.cli``).

    python -m tpu_slam_torch.cli.run_odometry --bag seq.bag --engine dense \\
        --set ndt.window_dims=192,192,32

Each runner runs on the GPU unless ``--device cpu`` is passed.
"""
