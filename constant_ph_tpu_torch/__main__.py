from constant_ph_tpu_torch.cli import main

main()
