from kge_tpu_torch.cli import main

main()
