"""Command-line runners of the port (the reference's ``tpu_slam.cli``):
run_odometry, run_slam, run_live (the rotating unit's live chain),
run_calibration, make_dataset and pcap_convert.

    python -m tpu_slam_torch.cli.run_odometry --bag seq.bag --engine dense \\
        --set ndt.window_dims=192,192,32

Each runner runs on the GPU unless ``--device cpu`` is passed.
"""
