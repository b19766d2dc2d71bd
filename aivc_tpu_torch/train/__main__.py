from aivc_tpu_torch.train.run import main

if __name__ == "__main__":
    raise SystemExit(main())
