from blur_algorithms_tpu_torch.cli import main

raise SystemExit(main())
